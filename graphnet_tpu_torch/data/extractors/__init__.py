"""Extractors: tables of columns out of raw experiment files
(counterpart of ``graphnet_tpu/data/extractors``)."""

from graphnet_tpu_torch.data.extractors.extractor import (
    CombinedExtractor,
    Extractor,
)
from graphnet_tpu_torch.data.extractors.icecube import (
    I3Extractor,
    I3FeatureExtractor,
    I3FeatureExtractorIceCube86,
    I3FeatureExtractorIceCubeDeepCore,
    I3FeatureExtractorIceCubeUpgrade,
    I3FrameObjectExtractor,
    I3GalacticPlaneHybridRecoExtractor,
    I3GenericExtractor,
    I3NTMuonLabelExtractor,
    I3ParticleExtractor,
    I3PISAExtractor,
    I3PulseNoiseTruthFlagIceCubeUpgrade,
    I3QUESOExtractor,
    I3RetroExtractor,
    I3SplineMPEICExtractor,
    I3TruthExtractor,
    I3TUMExtractor,
)
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
