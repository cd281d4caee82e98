"""Prometheus-simulation detectors (counterpart of
``graphnet_tpu/models/detector/prometheus.py``).

Every geometry shares the features ``sensor_pos_x/y/z, t`` with its own
position scalings; ``t`` is always ``x / 1.05e4``."""

from graphnet_tpu_torch.constants import PROMETHEUS_GEOMETRY_TABLE_DIR
from graphnet_tpu_torch.models.detector.detector import affine, make_detector

_T_SCALE = 1.05e4


def _prometheus(name, geometry_file, xy_scale, z_scale, z_offset=0.0):
    return make_detector(
        name,
        PROMETHEUS_GEOMETRY_TABLE_DIR,
        geometry_file,
        xyz=["sensor_pos_x", "sensor_pos_y", "sensor_pos_z"],
        string_id="sensor_string_id",
        sensor_id="sensor_id",
        fmap={
            "sensor_pos_x": affine(xy_scale),
            "sensor_pos_y": affine(xy_scale),
            "sensor_pos_z": affine(z_scale, z_offset),
            "t": affine(_T_SCALE),
        },
        module=__name__,
    )


ORCA150SuperDense = _prometheus(
    "ORCA150SuperDense", "orca_150.parquet", 100.0, 100.0, 350.0
)
TRIDENT1211 = _prometheus("TRIDENT1211", "trident.parquet", 1900.0, 3000.0)
IceCubeUpgrade7 = _prometheus(
    "IceCubeUpgrade7", "icecube_upgrade.parquet", 10.0, 2000.0
)
WaterDemo81 = _prometheus("WaterDemo81", "demo_water.parquet", 500.0, 2000.0)
BaikalGVD8 = _prometheus("BaikalGVD8", "gvd.parquet", 10.0, 1000.0)
IceDemo81 = _prometheus("IceDemo81", "demo_ice.parquet", 500.0, 3000.0)
ARCA115 = _prometheus("ARCA115", "arca.parquet", 100.0, 1000.0)
ORCA150 = _prometheus("ORCA150", "orca.parquet", 10.0, 100.0)
IceCube86Prometheus = _prometheus(
    "IceCube86Prometheus", "icecube86.parquet", 100.0, 1000.0
)
IceCubeDeepCore8 = _prometheus(
    "IceCubeDeepCore8", "icecube_deepcore.parquet", 100.0, 1000.0
)
IceCubeGen2 = _prometheus(
    "IceCubeGen2", "icecube_gen2.parquet", 1000.0, 1000.0
)
PONETriangle = _prometheus(
    "PONETriangle", "pone_triangle.parquet", 100.0, 100.0
)

# the alias the reference's examples use
Prometheus = ORCA150SuperDense
