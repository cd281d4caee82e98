"""The production input path: fit the bucket set to the dataset, pack
the padded batches to disk once, then train from the replayed store
(counterpart of ``examples/01_data/06_materialize_and_replay.py``).

    python -m graphnet_tpu_torch.examples.materialize_and_replay
    python -m graphnet_tpu_torch.examples.materialize_and_replay --device cpu

The host pipeline (SQL, graph building, padding) runs once, in
``materialize``; every epoch after replays the packed batches through
one copy each.  The model trains on the GPU unless ``--device cpu`` is
given.
"""

from __future__ import annotations

import logging
import os
import shutil
import tempfile

import numpy as np

from graphnet_tpu_torch.constants import EXAMPLE_SQLITE_DATA
from graphnet_tpu_torch.data.bucketing import optimize_buckets, padding_efficiency
from graphnet_tpu_torch.data.constants import FEATURES, TRUTH
from graphnet_tpu_torch.data.dataloader import DataLoader
from graphnet_tpu_torch.data.materialized import MaterializedLoader, materialize
from graphnet_tpu_torch.data.sqlite_dataset import SQLiteDataset
from graphnet_tpu_torch.examples.common import add_device_arguments
from graphnet_tpu_torch.models.detector.prometheus import Prometheus
from graphnet_tpu_torch.models.gnn.dynedge import DynEdge
from graphnet_tpu_torch.models.graphs import KNNGraph
from graphnet_tpu_torch.models.standard_model import StandardModel
from graphnet_tpu_torch.models.task.reconstruction import EnergyReconstruction
from graphnet_tpu_torch.training.loss_functions import LogCoshLoss
from graphnet_tpu_torch.training.trainer import Trainer
from graphnet_tpu_torch.utils.argparse import ArgumentParser
from graphnet_tpu_torch.utils.config import TRANSFORM_REGISTRY


def parse_args(argv=None):
    parser = ArgumentParser(
        description="Pack the padded batches once, train from the replay")
    return add_device_arguments(parser).parse_args(argv)


def build(args):
    """The loader (batches of 16 over buckets fitted to the dataset) and
    the example's narrow DynEdge energy model."""
    ds = SQLiteDataset(
        path=EXAMPLE_SQLITE_DATA,
        graph_definition=KNNGraph(detector=Prometheus()),
        pulsemaps="total",
        features=FEATURES.PROMETHEUS,
        truth=TRUTH.PROMETHEUS,
        truth_table="mc_truth",
    )
    # 1. the bucket set fitted to this dataset (padding against shapes)
    lengths = ds.event_lengths()
    buckets = optimize_buckets(lengths, n_buckets=3)
    print(f"optimized buckets: {buckets} "
          f"(padding efficiency {padding_efficiency(lengths, buckets):.2f})")
    loader = DataLoader(ds, batch_size=16, shuffle=True, seed=args.seed,
                        buckets=buckets)
    backbone = DynEdge(nb_inputs=4, dynedge_layer_sizes=((16, 16),))
    model = StandardModel(
        backbone=backbone,
        tasks=[EnergyReconstruction(
            hidden_size=backbone.nb_outputs, loss_function=LogCoshLoss(),
            target_labels=("total_energy",),
            transform_prediction_and_target=TRANSFORM_REGISTRY["log10"])],
        device=args.device,
    )
    return loader, model


def train(args, loader, model, store=None):
    """2. pack the batches to ``store`` (a temporary directory by
    default, removed after), 3. train two epochs from the replay."""
    tmp = None if store is not None else tempfile.mkdtemp()
    store = store or os.path.join(tmp, "store")
    try:
        meta = materialize(loader, store)
        print(f"packed {meta['n_batches']} batches "
              f"({len(meta['groups'])} shapes) to {store}")
        replay = MaterializedLoader(store, shuffle=True, seed=1,
                                    device=args.device)
        trainer = Trainer(model)
        history = trainer.fit(replay, max_epochs=2)
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
    print("train_loss per epoch:", np.round(history["train_loss"], 4))
    return trainer, history


def main(argv=None) -> Trainer:
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    args = parse_args(argv)
    return train(args, *build(args))[0]


if __name__ == "__main__":
    main()
