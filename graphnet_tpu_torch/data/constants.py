"""Feature and truth column names per experiment (counterpart of
``graphnet_tpu/data/constants.py``): the storage-schema names the
extractors write, fixed by the experiments' file formats."""


def _cols(spec: str):
    return spec.split()


class FEATURES:
    """Standard pulse-level feature column sets."""

    ICECUBE86 = _cols("dom_x dom_y dom_z dom_time charge rde pmt_area")
    DEEPCORE = ICECUBE86
    UPGRADE = DEEPCORE + _cols(
        "string pmt_number dom_number pmt_dir_x pmt_dir_y pmt_dir_z"
        " dom_type"
    )
    PROMETHEUS = _cols("sensor_pos_x sensor_pos_y sensor_pos_z t")
    KAGGLE = _cols("x y z time charge auxiliary")
    LIQUIDO = _cols("sipm_x sipm_y sipm_z t")


class TRUTH:
    """Standard event-level truth column sets."""

    ICECUBE86 = _cols(
        "energy energy_track energy_cascade position_x position_y"
        " position_z azimuth zenith pid elasticity interaction_type"
        " interaction_time inelasticity stopped_muon"
    )
    DEEPCORE = ICECUBE86
    UPGRADE = DEEPCORE
    PROMETHEUS = _cols(
        "injection_energy injection_type injection_interaction_type"
        " injection_zenith injection_azimuth injection_bjorkenx"
        " injection_bjorkeny injection_position_x injection_position_y"
        " injection_position_z injection_column_depth"
        " primary_lepton_1_type primary_hadron_1_type"
        " primary_lepton_1_position_x primary_lepton_1_position_y"
        " primary_lepton_1_position_z primary_hadron_1_position_x"
        " primary_hadron_1_position_y primary_hadron_1_position_z"
        " primary_lepton_1_direction_theta primary_lepton_1_direction_phi"
        " primary_hadron_1_direction_theta primary_hadron_1_direction_phi"
        " primary_lepton_1_energy primary_hadron_1_energy total_energy"
    )
    KAGGLE = _cols("zenith azimuth")
    LIQUIDO = _cols(
        "vertex_x vertex_y vertex_z zenith azimuth interaction_time"
        " energy pid"
    )
