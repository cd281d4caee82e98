"""Datasets of the PyTorch/CUDA port (counterpart of
``graphnet_tpu/datasets``): the curated ``TestDataset`` over the bundled
data, the public Prometheus datasets (downloaded on first use) and the
synthetic Prometheus database (``synthetic.py``)."""

from graphnet_tpu_torch.datasets.prometheus_datasets import (
    BaikalGVDSmall,
    PONESmall,
    PublicPrometheusDataset,
    TRIDENTSmall,
)
from graphnet_tpu_torch.datasets.test_dataset import TestDataset
