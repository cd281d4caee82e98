"""Readers of raw experiment files (counterpart of
``graphnet_tpu/data/readers``; the IceTray reader is not ported yet)."""

from graphnet_tpu_torch.data.readers.reader import GraphNeTFileReader
from graphnet_tpu_torch.data.readers.prometheus_reader import PrometheusReader
from graphnet_tpu_torch.data.readers.liquido_reader import LiquidOReader
from graphnet_tpu_torch.data.readers.internal_parquet_reader import (
    ParquetReader,
)
