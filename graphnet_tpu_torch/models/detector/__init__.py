"""Detector definitions (counterpart of ``graphnet_tpu/models/detector``)."""

from graphnet_tpu_torch.models.detector.detector import (
    Detector,
    available_detectors,
    get_detector,
)
from graphnet_tpu_torch.models.detector.icecube import (
    IceCube86,
    IceCubeDeepCore,
    IceCubeKaggle,
    IceCubeUpgrade,
)
from graphnet_tpu_torch.models.detector.liquido import LiquidO_v1
from graphnet_tpu_torch.models.detector.prometheus import (
    ARCA115,
    BaikalGVD8,
    IceCube86Prometheus,
    IceCubeDeepCore8,
    IceCubeGen2,
    IceCubeUpgrade7,
    IceDemo81,
    ORCA150,
    ORCA150SuperDense,
    PONETriangle,
    Prometheus,
    TRIDENT1211,
    WaterDemo81,
)
