"""Extractors: tables of columns out of raw experiment files
(counterpart of ``graphnet_tpu/data/extractors``; the IceTray
extractors are not ported yet)."""

from graphnet_tpu_torch.data.extractors.extractor import Extractor
from graphnet_tpu_torch.data.extractors.prometheus import (
    PrometheusExtractor,
    PrometheusFeatureExtractor,
    PrometheusTruthExtractor,
)
from graphnet_tpu_torch.data.extractors.liquido import (
    H5Extractor,
    H5HitExtractor,
    H5TruthExtractor,
)
from graphnet_tpu_torch.data.extractors.internal import ParquetExtractor
