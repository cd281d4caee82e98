"""Train DynEdge through the whole input pipeline (counterpart of
``examples/03_training/08_high_throughput_pipeline.py``).

    python -m graphnet_tpu_torch.examples.high_throughput_pipeline
    python -m graphnet_tpu_torch.examples.high_throughput_pipeline --device cpu --n-events 64

* ``DataLoader(stack_k=k)``: k batches of one shape stacked on the host,
  copied to the device at once;
* ``Trainer(steps_per_dispatch=k)``: k optimiser steps a group, in the
  JAX Trainer's order;
* ``Trainer.fit(prefetch=N)``: every epoch through one producer thread
  that builds and copies the batches ahead;
* the DataLoader's default ``buckets="auto:2"``: the two lengths that
  pad this dataset least.

The data is a synthetic database bootstrapped from the bundled 50-event
Prometheus database (``--n-events``), made once in the temporary
directory.  The model (full-width DynEdge in bfloat16) trains on the GPU
unless ``--device cpu`` is given.
"""

from __future__ import annotations

import logging

from graphnet_tpu_torch.data.constants import FEATURES, TRUTH
from graphnet_tpu_torch.data.dataloader import DataLoader
from graphnet_tpu_torch.data.sqlite_dataset import SQLiteDataset
from graphnet_tpu_torch.datasets.synthetic import cached_prometheus_db
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
        description="High-throughput DynEdge training pipeline"
    ).with_standard_arguments(("batch-size", 32), "max-epochs")
    parser.add_argument("--n-events", type=int, default=512)
    parser.add_argument("--stack-k", type=int, default=4)
    parser.add_argument("--prefetch", type=int, default=4)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return parser.parse_args(argv)


def build(args, backbone=None):
    """The stacked, threaded loader over the synthetic database and the
    model (full-width bfloat16 DynEdge unless ``backbone`` is given)."""
    dataset = SQLiteDataset(
        path=cached_prometheus_db(n_events=args.n_events, seed=0),
        graph_definition=KNNGraph(detector=Prometheus()),
        pulsemaps="total",
        features=FEATURES.PROMETHEUS,
        truth=TRUTH.PROMETHEUS,
        truth_table="mc_truth",
    )
    loader = DataLoader(dataset, batch_size=args.batch_size, shuffle=True,
                        seed=0, num_workers=2, stack_k=args.stack_k,
                        drop_last=True)
    backbone = backbone or DynEdge(nb_inputs=4, compute_dtype="bfloat16")
    model = StandardModel(
        backbone=backbone,
        tasks=[EnergyReconstruction(
            hidden_size=backbone.nb_outputs, loss_function=LogCoshLoss(),
            target_labels=("total_energy",),
            transform_prediction_and_target=TRANSFORM_REGISTRY["log10"])],
        device=args.device,
    )
    return loader, model


def train(args, loader, model):
    trainer = Trainer(model, steps_per_dispatch=args.stack_k)
    history = trainer.fit(loader, max_epochs=args.max_epochs,
                          use_default_schedule=False, prefetch=args.prefetch)
    return trainer, history


def main(argv=None) -> Trainer:
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    args = parse_args(argv)
    trainer, history = train(args, *build(args))
    print("train_loss per epoch:",
          [round(x, 4) for x in history["train_loss"]])
    return trainer


if __name__ == "__main__":
    main()
