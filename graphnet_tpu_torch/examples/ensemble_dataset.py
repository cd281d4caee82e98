"""Combine datasets with ``EnsembleDataset`` and summarise the feature
distributions (counterpart of ``examples/01_data/02_ensemble_dataset.py``).

    python -m graphnet_tpu_torch.examples.ensemble_dataset

Two selections of the bundled Prometheus database (even and odd event
numbers) as two datasets, concatenated; prints the mean, spread, minimum
and maximum of each standardised node feature over every pulse, and
returns the feature matrix.
"""

from __future__ import annotations

import numpy as np

from graphnet_tpu_torch.constants import EXAMPLE_SQLITE_DATA
from graphnet_tpu_torch.data.constants import FEATURES, TRUTH
from graphnet_tpu_torch.data.dataset import EnsembleDataset
from graphnet_tpu_torch.data.sqlite_dataset import SQLiteDataset
from graphnet_tpu_torch.models.detector.prometheus import Prometheus
from graphnet_tpu_torch.models.graphs import KNNGraph


def make_dataset(selection):
    return SQLiteDataset(
        path=EXAMPLE_SQLITE_DATA,
        graph_definition=KNNGraph(detector=Prometheus()),
        pulsemaps="total",
        features=FEATURES.PROMETHEUS,
        truth=TRUTH.PROMETHEUS,
        truth_table="mc_truth",
        selection=selection,
    )


def main() -> np.ndarray:
    even = make_dataset("event_no % 2 == 0")
    odd = make_dataset("event_no % 2 == 1")
    ensemble = EnsembleDataset([even, odd])
    print(f"datasets: even={len(even)} odd={len(odd)} "
          f"ensemble={len(ensemble)}")
    assert len(ensemble) == len(even) + len(odd)

    xs = np.concatenate([ensemble[i].x for i in range(len(ensemble))], axis=0)
    names = ensemble[0].features
    print(f"{'feature':<16} {'mean':>8} {'std':>8} {'min':>8} {'max':>8}")
    for j, name in enumerate(names):
        col = xs[:, j]
        print(f"{name:<16} {col.mean():>8.3f} {col.std():>8.3f} "
              f"{col.min():>8.3f} {col.max():>8.3f}")
    return xs


if __name__ == "__main__":
    main()
