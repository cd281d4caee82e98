"""Train DeepIce (IceMix) for direction reconstruction on the bundled
Prometheus SQLite database (counterpart of
``examples/03_training/03_train_deepice.py``).

    python -m graphnet_tpu_torch.examples.train_deepice --max-epochs 1
    python -m graphnet_tpu_torch.examples.train_deepice --device cpu

DeepIce reads Kaggle-style features (x, y, z, time, charge, auxiliary);
the bundled data has four (position and time), so it runs with
``n_features=4`` at the JAX example's narrow widths (hidden 96, six
heads of 16, depth 3 and 2 relative blocks).  The model trains on the
GPU unless ``--device cpu`` is given.
"""

from __future__ import annotations

import logging

from graphnet_tpu_torch.constants import EXAMPLE_SQLITE_DATA
from graphnet_tpu_torch.data.constants import FEATURES, TRUTH
from graphnet_tpu_torch.data.dataloader import DataLoader
from graphnet_tpu_torch.data.sqlite_dataset import SQLiteDataset
from graphnet_tpu_torch.examples.common import (
    add_device_arguments,
    print_predictions,
)
from graphnet_tpu_torch.models.detector.prometheus import Prometheus
from graphnet_tpu_torch.models.gnn.icemix import DeepIce
from graphnet_tpu_torch.models.graphs import EdgelessGraph
from graphnet_tpu_torch.models.standard_model import StandardModel
from graphnet_tpu_torch.models.task.reconstruction import (
    DirectionReconstructionWithKappa,
)
from graphnet_tpu_torch.training.labels import Direction
from graphnet_tpu_torch.training.loss_functions import VonMisesFisher3DLoss
from graphnet_tpu_torch.training.trainer import Trainer
from graphnet_tpu_torch.utils.argparse import ArgumentParser


def parse_args(argv=None):
    parser = ArgumentParser(
        description="Train DeepIce direction reconstruction"
    ).with_standard_arguments(("batch-size", 8), "max-epochs",
                              "learning-rate")
    parser.add_argument("--path", default=EXAMPLE_SQLITE_DATA)
    return add_device_arguments(parser).parse_args(argv)


def build(args):
    """The training loader and the model of the example."""
    dataset = SQLiteDataset(
        path=args.path,
        graph_definition=EdgelessGraph(detector=Prometheus()),
        pulsemaps="total",
        features=FEATURES.PROMETHEUS,
        truth=TRUTH.PROMETHEUS,
        truth_table="mc_truth",
        labels={"direction": Direction(azimuth_key="injection_azimuth",
                                       zenith_key="injection_zenith")},
    )
    loader = DataLoader(dataset, batch_size=args.batch_size, shuffle=True,
                        seed=args.seed)
    model = StandardModel(
        backbone=DeepIce(hidden_dim=96, seq_length=64, depth=3, depth_rel=2,
                         head_size=16, n_features=4),
        tasks=[DirectionReconstructionWithKappa(
            hidden_size=96, loss_function=VonMisesFisher3DLoss(),
            target_labels=("direction",))],
        device=args.device,
    )
    return loader, model


def train(args, loader, model) -> Trainer:
    trainer = Trainer(model, learning_rate=args.learning_rate)
    trainer.fit(loader, max_epochs=args.max_epochs)
    return trainer


def main(argv=None) -> Trainer:
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    args = parse_args(argv)
    loader, model = build(args)
    trainer = train(args, loader, model)
    print_predictions(trainer, loader)
    return trainer


if __name__ == "__main__":
    main()
