"""LiquidO detector (counterpart of
``graphnet_tpu/models/detector/liquido.py``)."""

from graphnet_tpu_torch.constants import LIQUIDO_GEOMETRY_TABLE_DIR
from graphnet_tpu_torch.models.detector.detector import affine, make_detector

LiquidO_v1 = make_detector(
    "LiquidO_v1",
    LIQUIDO_GEOMETRY_TABLE_DIR,
    "liquido_v1.parquet",
    xyz=["sipm_x", "sipm_y", "sipm_z"],
    string_id="fiber_id",
    sensor_id="sipm_id",
    fmap={
        "sipm_x": affine(1000.0),
        "sipm_y": affine(1000.0),
        "sipm_z": affine(1000.0),
        "t": affine(500.0),
    },
    module=__name__,
)
