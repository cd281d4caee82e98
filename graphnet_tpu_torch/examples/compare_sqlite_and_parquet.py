"""Check that the SQLite and Parquet backends agree event by event
(counterpart of ``examples/01_data/04_compare_sqlite_and_parquet.py``).

    python -m graphnet_tpu_torch.examples.compare_sqlite_and_parquet

Every event of the bundled Parquet dataset against the event of the same
``event_no`` in the bundled database: its pulse count, its node features
and its energy.  Returns the largest node-feature difference.
"""

from __future__ import annotations

import numpy as np

from graphnet_tpu_torch.constants import EXAMPLE_PARQUET_DATA, EXAMPLE_SQLITE_DATA
from graphnet_tpu_torch.data.constants import FEATURES, TRUTH
from graphnet_tpu_torch.data.parquet_dataset import ParquetDataset
from graphnet_tpu_torch.data.sqlite_dataset import SQLiteDataset
from graphnet_tpu_torch.models.detector.prometheus import Prometheus
from graphnet_tpu_torch.models.graphs import KNNGraph


def main() -> float:
    common = dict(
        pulsemaps="total",
        features=FEATURES.PROMETHEUS,
        truth=TRUTH.PROMETHEUS,
        truth_table="mc_truth",
    )
    sq = SQLiteDataset(path=EXAMPLE_SQLITE_DATA,
                       graph_definition=KNNGraph(detector=Prometheus()),
                       **common)
    pq = ParquetDataset(path=EXAMPLE_PARQUET_DATA,
                        graph_definition=KNNGraph(detector=Prometheus()),
                        **common)
    assert len(sq) == len(pq), (len(sq), len(pq))

    # the Parquet dataset runs in chunk order: align by event_no
    sq_by_no = {int(sq[i].labels["event_no"]): sq[i] for i in range(len(sq))}
    worst = 0.0
    for i in range(len(pq)):
        ev_p = pq[i]
        ev_s = sq_by_no[int(ev_p.labels["event_no"])]
        assert ev_p.n_pulses == ev_s.n_pulses
        worst = max(worst, float(np.abs(ev_p.x - ev_s.x).max()))
        np.testing.assert_allclose(float(ev_p.labels["total_energy"]),
                                   float(ev_s.labels["total_energy"]),
                                   rtol=1e-6)
    print(f"{len(pq)} events agree across backends "
          f"(max node-feature deviation {worst:.2e})")
    return worst


if __name__ == "__main__":
    main()
