"""Train RNN_TITO, a GRU over each sensor's pulse series feeding
DynEdgeTITO, for energy regression on the bundled Prometheus SQLite
database (counterpart of ``examples/03_training/05_train_rnn_tito.py``).

    python -m graphnet_tpu_torch.examples.train_rnn_tito --max-epochs 1
    python -m graphnet_tpu_torch.examples.train_rnn_tito --device cpu

``NodeAsDOMTimeSeries`` sorts the pulses by time, groups them per sensor
and marks where each sensor's series starts; the GRU reads each series
from a zero state.  The widths are the JAX example's (GRU 32, one
DynTrans block of 64 with four heads of 16).  The model trains on the
GPU unless ``--device cpu`` is given.
"""

from __future__ import annotations

import logging

from graphnet_tpu_torch.constants import EXAMPLE_SQLITE_DATA
from graphnet_tpu_torch.data.constants import FEATURES, TRUTH
from graphnet_tpu_torch.data.dataloader import DataLoader
from graphnet_tpu_torch.data.sqlite_dataset import SQLiteDataset
from graphnet_tpu_torch.examples.common import add_device_arguments
from graphnet_tpu_torch.models.detector.prometheus import Prometheus
from graphnet_tpu_torch.models.gnn.rnn_tito import RNNTITO
from graphnet_tpu_torch.models.graphs import KNNGraph
from graphnet_tpu_torch.models.graphs.nodes import NodeAsDOMTimeSeries
from graphnet_tpu_torch.models.standard_model import StandardModel
from graphnet_tpu_torch.models.task.reconstruction import EnergyReconstruction
from graphnet_tpu_torch.training.loss_functions import LogCoshLoss
from graphnet_tpu_torch.training.trainer import Trainer
from graphnet_tpu_torch.utils.argparse import ArgumentParser
from graphnet_tpu_torch.utils.config import TRANSFORM_REGISTRY


def parse_args(argv=None):
    parser = ArgumentParser(
        description="Train RNN_TITO energy regression"
    ).with_standard_arguments(("batch-size", 8), "max-epochs",
                              "early-stopping-patience", "learning-rate")
    parser.add_argument("--path", default=EXAMPLE_SQLITE_DATA)
    return add_device_arguments(parser).parse_args(argv)


def build(args):
    """The training loader and the model of the example."""
    features = FEATURES.PROMETHEUS  # sensor_pos_{x,y,z}, t
    graph_definition = KNNGraph(
        detector=Prometheus(),
        node_definition=NodeAsDOMTimeSeries(
            keys=features, id_columns=features[:3], time_column="t",
            charge_column="t_not_a_charge",  # Prometheus has no charge
        ),
    )
    dataset = SQLiteDataset(
        path=args.path,
        graph_definition=graph_definition,
        pulsemaps="total",
        features=features,
        truth=TRUTH.PROMETHEUS,
        truth_table="mc_truth",
    )
    loader = DataLoader(dataset, batch_size=args.batch_size, shuffle=True,
                        seed=args.seed)
    # node features: x, y, z, t, a unit charge, new_node_col
    backbone = RNNTITO(
        nb_inputs=len(graph_definition.output_feature_names),
        time_series_columns=(4, 3),  # (charge, time)
        rnn_hidden_size=32,
        rnn_layers=1,
        dyntrans_layer_sizes=((64, 64),),
        n_head=4,
    )
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
    trainer = Trainer(model, learning_rate=args.learning_rate)
    history = trainer.fit(loader, max_epochs=args.max_epochs,
                          early_stopping_patience=args.early_stopping_patience)
    return trainer, history


def main(argv=None) -> Trainer:
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    args = parse_args(argv)
    loader, model = build(args)
    trainer, history = train(args, loader, model)
    print("final train loss:", history["train_loss"][-1])
    return trainer


if __name__ == "__main__":
    main()
