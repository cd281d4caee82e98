"""IceCube detectors (counterpart of
``graphnet_tpu/models/detector/icecube.py``): IceCube-86, the Kaggle
IceCube data's columns, DeepCore and the IceCube Upgrade."""

from graphnet_tpu_torch.constants import ICECUBE_GEOMETRY_TABLE_DIR
from graphnet_tpu_torch.models.detector.detector import (
    affine,
    identity,
    log10_scale,
    make_detector,
    mul_offset,
    scaled_shift,
)

IceCube86 = make_detector(
    "IceCube86",
    ICECUBE_GEOMETRY_TABLE_DIR,
    "icecube86.parquet",
    xyz=["dom_x", "dom_y", "dom_z"],
    string_id="string",
    sensor_id="sensor_id",
    fmap={
        "dom_x": affine(500.0),
        "dom_y": affine(500.0),
        "dom_z": affine(500.0),
        "dom_time": affine(3.0e4, -1.0e4),
        "charge": log10_scale(),
        "rde": affine(0.25, -1.25),
        "pmt_area": affine(0.05),
        "hlc": identity(),
    },
    module=__name__,
)

IceCubeKaggle = make_detector(
    "IceCubeKaggle",
    ICECUBE_GEOMETRY_TABLE_DIR,
    "icecube86.parquet",
    xyz=["x", "y", "z"],
    string_id="string",
    sensor_id="sensor_id",
    fmap={
        "x": affine(500.0),
        "y": affine(500.0),
        "z": affine(500.0),
        "time": affine(3.0e4, -1.0e4),
        "charge": log10_scale(3.0),
        "auxiliary": identity(),
    },
    module=__name__,
)

IceCubeDeepCore = make_detector(
    "IceCubeDeepCore",
    ICECUBE_GEOMETRY_TABLE_DIR,
    "icecube86.parquet",
    xyz=["dom_x", "dom_y", "dom_z"],
    string_id="string",
    sensor_id="sensor_id",
    fmap={
        "dom_x": affine(100.0),
        "dom_y": affine(100.0),
        "dom_z": affine(100.0, 350.0),
        # (x / 1.05e4 - 1) * 20
        "dom_time": scaled_shift(1.05e4, -1.0, 20.0),
        "charge": identity(),
        "rde": affine(0.25, -1.25),
        "pmt_area": affine(0.05),
        "hlc": identity(),
    },
    module=__name__,
)

IceCubeUpgrade = make_detector(
    "IceCubeUpgrade",
    ICECUBE_GEOMETRY_TABLE_DIR,
    "icecube_upgrade.parquet",
    xyz=["dom_x", "dom_y", "dom_z"],
    string_id="string",
    sensor_id="sensor_id",
    fmap={
        "dom_x": affine(500.0),
        "dom_y": affine(500.0),
        "dom_z": affine(500.0),
        # x / 2e4 - 1
        "dom_time": mul_offset(2.0e4, -1.0),
        "charge": log10_scale(2.0),
        "rde": identity(),
        "pmt_area": affine(0.05),
        "string": affine(50.0, -50.0),
        "pmt_number": affine(20.0),
        "dom_number": affine(60.0, -60.0),
        "pmt_dir_x": identity(),
        "pmt_dir_y": identity(),
        "pmt_dir_z": identity(),
        "dom_type": affine(130.0),
        "hlc": identity(),
    },
    module=__name__,
)
