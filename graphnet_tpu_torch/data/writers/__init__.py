"""Writers of the intermediate formats (counterpart of
``graphnet_tpu/data/writers``)."""

from graphnet_tpu_torch.data.writers.writer import GraphNeTWriter
from graphnet_tpu_torch.data.writers.sqlite_writer import SQLiteWriter
from graphnet_tpu_torch.data.writers.parquet_writer import ParquetWriter
