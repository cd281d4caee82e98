"""Read events from the bundled SQLite and Parquet example datasets
(counterpart of ``examples/01_data/01_read_dataset.py``).

    python -m graphnet_tpu_torch.examples.read_dataset

Prints each backend's event count, event 0 and the shapes of a first
batch of 16; returns the two datasets and their first batches.
"""

from __future__ import annotations

from graphnet_tpu_torch.constants import EXAMPLE_PARQUET_DATA, EXAMPLE_SQLITE_DATA
from graphnet_tpu_torch.data.constants import FEATURES, TRUTH
from graphnet_tpu_torch.data.dataloader import DataLoader
from graphnet_tpu_torch.data.parquet_dataset import ParquetDataset
from graphnet_tpu_torch.data.sqlite_dataset import SQLiteDataset
from graphnet_tpu_torch.models.detector.prometheus import Prometheus
from graphnet_tpu_torch.models.graphs import KNNGraph


def main():
    common = dict(
        graph_definition=KNNGraph(detector=Prometheus()),
        pulsemaps="total",
        features=FEATURES.PROMETHEUS,
        truth=TRUTH.PROMETHEUS,
        truth_table="mc_truth",
    )
    out = {}
    for name, ds in [
        ("sqlite", SQLiteDataset(path=EXAMPLE_SQLITE_DATA, **common)),
        ("parquet", ParquetDataset(path=EXAMPLE_PARQUET_DATA, **common)),
    ]:
        print(f"[{name}] {len(ds)} events")
        ev = ds[0]
        print(f"  event 0: {ev.n_pulses} pulses, features {ev.features}")
        batch = next(iter(DataLoader(ds, batch_size=16, shuffle=False)))
        print(
            f"  first batch: x{tuple(batch.x.shape)} "
            f"mask{tuple(batch.mask.shape)} "
            f"labels={sorted(batch.labels)[:4]}..."
        )
        out[name] = (ds, batch)
    return out


if __name__ == "__main__":
    main()
