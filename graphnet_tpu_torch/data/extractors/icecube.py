"""IceCube extractors (counterpart of
``graphnet_tpu/data/extractors/icecube.py``): per-pulse features of a
pulse map (the DOM's position, orientation, area and type from the GCD
file, the pulse's time, charge, width and local-coincidence bit, the
DOM's relative efficiency from the calibration) and per-event
quantities of named frame objects (Monte-Carlo truth, reconstructions,
event selections).

They read frames through IceTray's interface: the ``icecube`` stack is
imported inside the calls that decode pulse maps or GCD files, and at
module level only where it is installed, as in the JAX package.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from graphnet_tpu_torch.data.extractors.extractor import Extractor
from graphnet_tpu_torch.utils.imports import has_icecube_package

if has_icecube_package():
    from icecube import (  # pyright: ignore # noqa: F401
        dataclasses,
        icetray,
    )


def frame_is_montecarlo(frame, mctree: str = "I3MCTree") -> bool:
    """Whether the frame carries Monte-Carlo truth (GraphNeT's
    ``extractors/icecube/utilities/frames.py:14-18``)."""
    return ("MCInIcePrimary" in frame) or (mctree in frame)


def frame_is_noise(frame, mctree: str = "I3MCTree") -> bool:
    """Whether the frame is a pure-noise event: no primary with an
    energy in either truth container (GraphNeT's ``frames.py:21-33``)."""
    try:
        frame[mctree][0].energy
        return False
    except Exception:
        try:
            frame["MCInIcePrimary"].energy
            return False
        except Exception:
            return True


class I3Extractor(Extractor):
    """Base for extractors operating on (physics frame, gcd file)."""

    def __init__(self, extractor_name: str):
        super().__init__(extractor_name=extractor_name)
        self._i3_file: Optional[str] = None
        self._gcd_file: Optional[str] = None
        self._gcd_dict: Optional[Dict] = None
        self._calibration = None

    def set_gcd(self, i3_file: str, gcd_file: Optional[str] = None) -> None:
        """Read the first ``I3Geometry`` and ``I3Calibration`` of the
        GCD file (of ``i3_file`` where none is given)."""
        from icecube import dataio  # pyright: ignore

        gcd = dataio.I3File(gcd_file or i3_file)
        g_frame = None
        c_frame = None
        while gcd.more() and (g_frame is None or c_frame is None):
            frame = gcd.pop_frame()
            if "I3Geometry" in frame and g_frame is None:
                g_frame = frame["I3Geometry"]
            if "I3Calibration" in frame and c_frame is None:
                c_frame = frame["I3Calibration"]
        assert g_frame is not None, "no I3Geometry in GCD"
        self._gcd_dict = g_frame.omgeo
        self._calibration = c_frame

    def __call__(self, frame) -> Dict[str, Any]:
        raise NotImplementedError


class I3FeatureExtractor(I3Extractor):
    """Pulse-map feature extraction base."""

    def __init__(self, pulsemap: str):
        super().__init__(extractor_name=pulsemap)
        self._pulsemap = pulsemap

    def _get_pulse_map(self, frame):
        from icecube import dataclasses  # pyright: ignore

        return dataclasses.I3RecoPulseSeriesMap.from_frame(
            frame, self._pulsemap
        )


class I3FeatureExtractorIceCube86(I3FeatureExtractor):
    """dom_x/y/z, time, charge, rde, pmt_area, hlc per pulse
    (GraphNeT's ``i3featureextractor.py:31-205``)."""

    def __call__(self, frame) -> Dict[str, List[float]]:
        output: Dict[str, List[float]] = {
            k: []
            for k in (
                "charge",
                "dom_time",
                "dom_x",
                "dom_y",
                "dom_z",
                "width",
                "pmt_area",
                "rde",
                "hlc",
            )
        }
        try:
            pulse_map = self._get_pulse_map(frame)
        except KeyError:
            return output
        assert self._gcd_dict is not None, "call set_gcd first"
        for om_key, pulses in pulse_map.items():
            om = self._gcd_dict[om_key]
            rde = self._get_relative_dom_efficiency(om_key)
            for pulse in pulses:
                output["charge"].append(pulse.charge)
                output["dom_time"].append(pulse.time)
                output["width"].append(pulse.width)
                output["pmt_area"].append(om.area)
                output["rde"].append(rde)
                output["dom_x"].append(om.position.x)
                output["dom_y"].append(om.position.y)
                output["dom_z"].append(om.position.z)
                output["hlc"].append(
                    (pulse.flags & pulse.PulseFlags.LC) >> 1
                )
        return output

    def _get_relative_dom_efficiency(self, om_key) -> float:
        try:
            return self._calibration.dom_cal[om_key].relative_dom_eff
        except (KeyError, AttributeError):
            return -1.0


class I3FeatureExtractorIceCubeDeepCore(I3FeatureExtractorIceCube86):
    """Identical columns; DeepCore pulse maps."""


class I3FeatureExtractorIceCubeUpgrade(I3FeatureExtractorIceCube86):
    """Adds string/pmt_number/dom_number/pmt direction/dom_type columns
    (GraphNeT's ``i3featureextractor.py:208-260``)."""

    def __call__(self, frame) -> Dict[str, List[float]]:
        output = super().__call__(frame)
        extra: Dict[str, List[float]] = {
            k: []
            for k in (
                "string",
                "pmt_number",
                "dom_number",
                "pmt_dir_x",
                "pmt_dir_y",
                "pmt_dir_z",
                "dom_type",
            )
        }
        try:
            pulse_map = self._get_pulse_map(frame)
        except KeyError:
            output.update(extra)
            return output
        assert self._gcd_dict is not None
        for om_key, pulses in pulse_map.items():
            om = self._gcd_dict[om_key]
            for _ in pulses:
                extra["string"].append(om_key[0])
                extra["pmt_number"].append(om_key[2])
                extra["dom_number"].append(om_key[1])
                extra["pmt_dir_x"].append(om.orientation.x)
                extra["pmt_dir_y"].append(om.orientation.y)
                extra["pmt_dir_z"].append(om.orientation.z)
                extra["dom_type"].append(om.omtype)
        output.update(extra)
        return output


class I3PulseNoiseTruthFlagIceCubeUpgrade(I3FeatureExtractorIceCubeUpgrade):
    """Upgrade features plus a per-pulse ``truth_flag`` column read from a
    noise-truth pulse map, where each stored entry *is* the flag value —
    the container is a key→vector-of-flags map, NOT an I3RecoPulseSeriesMap,
    so it is read straight off the frame (GraphNeT's
    ``i3featureextractor.py:263-307``)."""

    def __call__(self, frame) -> Dict[str, List[float]]:
        output = super().__call__(frame)
        output["truth_flag"] = []
        if self._pulsemap not in frame:
            return output
        for _, flags in frame[self._pulsemap].items():
            for truth_flag in flags:
                output["truth_flag"].append(truth_flag)
        return output


class I3FrameObjectExtractor(I3Extractor):
    """Copy scalar members of a named frame object into columns — the
    shared pattern behind GraphNeT's Retro/SplineMPE/TUM/PISA/QUESO
    extractors (``i3retroextractor.py:15``, ``i3splinempeextractor.py:11``,
    ``i3tumextractor.py:11``, ``i3pisaextractor.py:11``,
    ``i3quesoextractor.py:11``)."""

    def __init__(
        self,
        frame_key: str,
        members: Dict[str, str],
        extractor_name: Optional[str] = None,
        padding_value: float = -1.0,
    ):
        """Args:
        frame_key: name of the object in the physics frame.
        members: ``{output column: attribute path}``, where the path may be
            dotted (e.g. ``"pos.x"``, ``"dir.zenith"``).
        """
        super().__init__(extractor_name=extractor_name or frame_key)
        self._frame_key = frame_key
        self._members = members
        self._padding_value = padding_value

    def __call__(self, frame) -> Dict[str, float]:
        out = {k: self._padding_value for k in self._members}
        if self._frame_key not in frame:
            return out
        obj = frame[self._frame_key]
        for col, path in self._members.items():
            value = obj
            try:
                for attr in path.split("."):
                    value = getattr(value, attr)
                out[col] = float(value)
            except (AttributeError, TypeError, ValueError):
                pass
        return out


class I3RetroExtractor(I3FrameObjectExtractor):
    """RetroReco fit results (GraphNeT's ``i3retroextractor.py``)."""

    def __init__(self, frame_key: str = "retro_crs_prefit__median__neutrino"):
        super().__init__(
            frame_key=frame_key,
            members={
                "azimuth_retro": "dir.azimuth",
                "zenith_retro": "dir.zenith",
                "energy_retro": "energy",
                "position_x_retro": "pos.x",
                "position_y_retro": "pos.y",
                "position_z_retro": "pos.z",
                "time_retro": "time",
            },
            extractor_name="retro",
        )


class I3SplineMPEICExtractor(I3FrameObjectExtractor):
    """SplineMPE direction fit (GraphNeT's ``i3splinempeextractor.py``)."""

    def __init__(self, frame_key: str = "SplineMPEIC"):
        super().__init__(
            frame_key=frame_key,
            members={
                "zenith_spline_mpe_ic": "dir.zenith",
                "azimuth_spline_mpe_ic": "dir.azimuth",
            },
            extractor_name="spline_mpe_ic",
        )


class I3TUMExtractor(I3FrameObjectExtractor):
    """TUM DNN reco outputs (GraphNeT's ``i3tumextractor.py``)."""

    def __init__(self):
        super().__init__(
            frame_key="TUM_dnn_energy_hive",
            members={"tum_dnn_energy_hive": "value"},
            extractor_name="tum",
        )


class I3ParticleExtractor(I3FrameObjectExtractor):
    """Any I3Particle reco output (GraphNeT's ``i3particleextractor.py``)."""

    def __init__(self, extractor_name: str):
        super().__init__(
            frame_key=extractor_name,
            members={
                f"zenith_{extractor_name}": "dir.zenith",
                f"azimuth_{extractor_name}": "dir.azimuth",
                f"energy_{extractor_name}": "energy",
                f"pos_x_{extractor_name}": "pos.x",
                f"pos_y_{extractor_name}": "pos.y",
                f"pos_z_{extractor_name}": "pos.z",
                f"time_{extractor_name}": "time",
                f"speed_{extractor_name}": "speed",
                f"length_{extractor_name}": "length",
            },
            extractor_name=extractor_name,
        )


class I3QUESOExtractor(I3Extractor):
    """QUESO event-selection booleans (GraphNeT's ``i3quesoextractor.py``)."""

    def __init__(
        self,
        keys: Optional[List[str]] = None,
        extractor_name: str = "queso",
    ):
        super().__init__(extractor_name=extractor_name)
        self._keys = keys or ["QuesoL3_Bool", "QuesoL4_Bool", "QuesoL5_Bool"]

    def __call__(self, frame) -> Dict[str, float]:
        out = {}
        for key in self._keys:
            try:
                out[key] = float(frame[key].value)
            except KeyError:
                out[key] = -1.0
        return out


class I3GenericExtractor(I3Extractor):
    """Auto-serialise arbitrary frame objects (GraphNeT's
    ``i3genericextractor.py:29``): for each configured frame key, scalar
    numeric attributes of the object (or of each element of a map/series)
    are flattened into columns named ``<key>.<attr>``."""

    def __init__(
        self,
        keys: Optional[List[str]] = None,
        exclude_keys: Optional[List[str]] = None,
        extractor_name: str = "generic",
    ):
        super().__init__(extractor_name=extractor_name)
        self._keys = keys
        self._exclude = set(exclude_keys or [])

    @staticmethod
    def _scalar_members(obj) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for attr in dir(obj):
            if attr.startswith("_"):
                continue
            try:
                value = getattr(obj, attr)
            except Exception:
                continue
            if isinstance(value, (int, float, bool)):
                out[attr] = float(value)
            elif hasattr(value, "x") and hasattr(value, "y"):
                for c in ("x", "y", "z"):
                    if hasattr(value, c):
                        out[f"{attr}.{c}"] = float(getattr(value, c))
        return out

    def __call__(self, frame) -> Dict[str, Any]:
        keys = self._keys or [
            k for k in frame.keys() if k not in self._exclude
        ]
        output: Dict[str, Any] = {}
        for key in keys:
            if key not in frame:
                continue
            obj = frame[key]
            try:
                members = self._scalar_members(obj)
            except Exception:
                continue
            for name, value in members.items():
                output[f"{key}.{name}"] = value
        return output


class I3TruthExtractor(I3Extractor):
    """Per-event MC truth: energy, direction, vertex, pid, interaction
    type (GraphNeT's ``i3truthextractor.py:22-440``, core paths)."""

    def __init__(
        self,
        name: str = "truth",
        mctree: str = "I3MCTree",
    ):
        super().__init__(extractor_name=name)
        self._mctree = mctree

    def __call__(self, frame, padding_value: float = -1.0) -> Dict[str, Any]:
        from icecube import dataclasses  # pyright: ignore

        output: Dict[str, Any] = {
            k: padding_value
            for k in (
                "energy",
                "position_x",
                "position_y",
                "position_z",
                "azimuth",
                "zenith",
                "pid",
                "interaction_type",
                "interaction_time",
                "inelasticity",
                "energy_track",
                "energy_cascade",
            )
        }
        if self._mctree not in frame:
            return output
        tree = frame[self._mctree]
        primaries = tree.get_primaries()
        if not primaries:
            return output
        primary = primaries[0]
        output.update(
            energy=primary.energy,
            position_x=primary.pos.x,
            position_y=primary.pos.y,
            position_z=primary.pos.z,
            azimuth=primary.dir.azimuth,
            zenith=primary.dir.zenith,
            pid=primary.pdg_encoding,
            interaction_time=primary.time,
        )
        if "I3MCWeightDict" in frame:
            wd = frame["I3MCWeightDict"]
            output["interaction_type"] = wd.get(
                "InteractionType", padding_value
            )
            output["inelasticity"] = 1.0 - wd.get(
                "BjorkenY", 1.0 - padding_value
            )
        return output


class I3GalacticPlaneHybridRecoExtractor(I3Extractor):
    """Galactic-plane DNN-cascade hybrid reconstruction variables
    (GraphNeT's ``i3hybridrecoextractor.py:11-52``)."""

    _RENAMES = {
        "zen": "zenith_hybrid",
        "azi": "azimuth_hybrid",
        "logE": "energy_hybrid_log",
    }
    _KEYS = (
        "angErr", "angErr_uncorrected", "dec", "dpsi", "energy", "event",
        "ra", "run", "subevent", "time", "trueDec", "trueE", "trueRa",
        "true_azi", "true_zen",
    )

    def __init__(self, extractor_name: str = "dnn_hybrid"):
        super().__init__(extractor_name)

    def __call__(self, frame) -> Dict[str, Any]:
        output: Dict[str, Any] = {}
        key = "DNNCascadeAnalysis_version_001_p00"
        if key in frame:
            reco = frame[key]
            for k in self._KEYS:
                output[k] = reco[k]
            for src, dst in self._RENAMES.items():
                output[dst] = reco[src]
        return output


class I3NTMuonLabelExtractor(I3Extractor):
    """Muon labels of the Northern-Tracks dataset, padded when absent
    (GraphNeT's ``i3ntmuonlabelsextractor.py:11-58``)."""

    _KEYS = (
        "classification",
        "classification_ic79",
        "classification_emuon_deposited",
        "classification_emuon_entry",
        "classification_emuon_cascade_energy",
        "classification_emuon_track_energy",
        "classification_emuon_track_length",
        "energy_on_muon_appearance",
        "ic79_energy_on_muon_appearance",
        "ic79_classification_emuon_deposited",
        "ic79_classification_emuon_entry",
        "ic79_classification_emuon_cascade_energy",
        "ic79_classification_emuon_track_energy",
        "ic79_classification_emuon_track_length",
        "classification_label",
        "classification_label_ic79",
        "coincident_muons",
        "coincident_muons_ic79",
    )

    def __init__(
        self,
        extractor_name: str = "northeren_tracks_muon_labels",
        padding_value: float = -1,
    ):
        super().__init__(extractor_name)
        self._padding_value = padding_value

    def __call__(self, frame) -> Dict[str, Any]:
        output: Dict[str, Any] = {}
        for key in self._KEYS:
            try:
                output[key] = frame[key].value
            except KeyError:
                output[key] = self._padding_value
        return output


class I3PISAExtractor(I3Extractor):
    """Quantities required by the PISA oscillation-analysis framework
    (GraphNeT's ``i3pisaextractor.py:11-37``)."""

    _KEYS = ("OneWeight", "gen_ratio", "NEvents", "GENIEWeight")

    def __init__(self, extractor_name: str = "pisa_dependencies"):
        super().__init__(extractor_name)

    def __call__(
        self, frame, padding_value: float = -1.0
    ) -> Dict[str, Any]:
        output = {key: padding_value for key in self._KEYS}
        if "I3MCWeightDict" in frame:
            wd = frame["I3MCWeightDict"]
            for key in self._KEYS:
                try:
                    output[key] = wd[key]
                except KeyError:
                    pass
        return output
