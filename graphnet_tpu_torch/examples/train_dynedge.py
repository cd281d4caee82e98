"""Train DynEdge on energy regression from the bundled Prometheus SQLite
database (counterpart of ``examples/03_training/01_train_dynedge.py``).

    python -m graphnet_tpu_torch.examples.train_dynedge --max-epochs 2
    python -m graphnet_tpu_torch.examples.train_dynedge --device cpu

The model trains on the GPU unless ``--device cpu`` is given.  It writes
``model.yml`` and ``state_dict.pkl`` (the JAX package's formats) to
``--output``; both packages' ``DeploymentModule(model.yml,
state_dict.pkl)`` serve them.
"""

from __future__ import annotations

import argparse
import logging
import os
import tempfile

from graphnet_tpu_torch.constants import EXAMPLE_SQLITE_DATA
from graphnet_tpu_torch.data.constants import FEATURES, TRUTH
from graphnet_tpu_torch.data.datamodule import GraphNeTDataModule
from graphnet_tpu_torch.data.sqlite_dataset import SQLiteDataset
from graphnet_tpu_torch.models.detector.prometheus import Prometheus
from graphnet_tpu_torch.models.gnn.dynedge import DynEdge
from graphnet_tpu_torch.models.graphs import KNNGraph
from graphnet_tpu_torch.models.standard_model import StandardModel
from graphnet_tpu_torch.models.task.reconstruction import EnergyReconstruction
from graphnet_tpu_torch.training.loss_functions import LogCoshLoss
from graphnet_tpu_torch.training.trainer import Trainer
from graphnet_tpu_torch.utils.config import TRANSFORM_REGISTRY, save_model_config


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="Train DynEdge energy regression. Writes model.yml and "
        "state_dict.pkl to --output.",
    )
    parser.add_argument("--batch-size", type=int, default=16)
    parser.add_argument("--max-epochs", type=int, default=5)
    parser.add_argument("--early-stopping-patience", type=int, default=5)
    parser.add_argument("--learning-rate", type=float, default=1e-3)
    parser.add_argument("--path", default=EXAMPLE_SQLITE_DATA)
    parser.add_argument("--pulsemap", default="total")
    parser.add_argument("--target", default="total_energy")
    parser.add_argument("--truth-table", default="mc_truth")
    parser.add_argument(
        "--output",
        default=os.path.join(tempfile.gettempdir(), "dynedge_energy"),
    )
    parser.add_argument(
        "--device", default="cuda", help="cuda (default) or cpu"
    )
    parser.add_argument(
        "--seed", type=int, default=None,
        help="seed of the training loader's shuffle (default: none, a new "
        "order every run)",
    )
    return parser.parse_args(argv)


def build(args: argparse.Namespace):
    """The datamodule and the model of the example."""
    datamodule = GraphNeTDataModule(
        dataset_reference=SQLiteDataset,
        dataset_args=dict(
            path=args.path,
            graph_definition=KNNGraph(detector=Prometheus()),
            pulsemaps=args.pulsemap,
            features=FEATURES.PROMETHEUS,
            truth=TRUTH.PROMETHEUS,
            truth_table=args.truth_table,
        ),
        train_dataloader_kwargs={"batch_size": args.batch_size,
                                 "seed": args.seed},
        validation_dataloader_kwargs={"batch_size": args.batch_size},
    )
    model = StandardModel(
        DynEdge(
            nb_inputs=4,
            global_pooling_schemes=("min", "max", "mean", "sum"),
        ),
        [
            EnergyReconstruction(
                hidden_size=128,
                loss_function=LogCoshLoss(),
                target_labels=(args.target,),
                transform_prediction_and_target=TRANSFORM_REGISTRY["log10"],
            )
        ],
        device=args.device,
    )
    return datamodule, model


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    args = parse_args(argv)
    datamodule, model = build(args)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"DynEdge energy model: {n_params} parameters on {args.device}")
    trainer = Trainer(model, learning_rate=args.learning_rate)
    trainer.fit(
        datamodule.train_dataloader(),
        datamodule.val_dataloader(),
        max_epochs=args.max_epochs,
        early_stopping_patience=args.early_stopping_patience,
    )
    df = trainer.predict_as_dataframe(
        datamodule.val_dataloader(), additional_attributes=[args.target]
    )
    print(df.head())
    os.makedirs(args.output, exist_ok=True)
    save_model_config(model, os.path.join(args.output, "model.yml"))
    trainer.save_state_dict(os.path.join(args.output, "state_dict.pkl"))
    print(f"Saved model.yml and state_dict.pkl to {args.output}")


if __name__ == "__main__":
    main()
