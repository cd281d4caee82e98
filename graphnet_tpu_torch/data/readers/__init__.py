"""Readers of raw experiment files (counterpart of
``graphnet_tpu/data/readers``)."""

from graphnet_tpu_torch.data.readers.reader import GraphNeTFileReader
from graphnet_tpu_torch.data.readers.i3reader import I3FileSet, I3Reader
from graphnet_tpu_torch.data.readers.prometheus_reader import PrometheusReader
from graphnet_tpu_torch.data.readers.liquido_reader import LiquidOReader
from graphnet_tpu_torch.data.readers.internal_parquet_reader import (
    ParquetReader,
)
