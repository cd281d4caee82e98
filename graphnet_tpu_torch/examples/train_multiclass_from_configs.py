"""Multi-class flavour classification from config files alone
(counterpart of ``examples/03_training/07_train_multiclass_from_configs.py``):
a dataset config, ``configs/models/dynedge_pid_classification.yml`` and
a ``TrainingConfig``, no model code in the script.

    python -m graphnet_tpu_torch.examples.train_multiclass_from_configs --max-epochs 1
    python -m graphnet_tpu_torch.examples.train_multiclass_from_configs --device cpu

It trains on the GPU unless ``--device cpu`` is given, and prints the
validation predictions beside their truth (without pandas).
"""

from __future__ import annotations

import logging
import os

from graphnet_tpu_torch.constants import GRAPHNET_ROOT_DIR
from graphnet_tpu_torch.data.dataloader import DataLoader
from graphnet_tpu_torch.examples.common import (
    add_device_arguments,
    print_predictions,
)
from graphnet_tpu_torch.training.trainer import Trainer
from graphnet_tpu_torch.utils.argparse import ArgumentParser
from graphnet_tpu_torch.utils.config import (
    TrainingConfig,
    load_dataset,
    load_model,
)

CONFIG_DIR = os.path.join(GRAPHNET_ROOT_DIR, "configs")


def parse_args(argv=None):
    parser = ArgumentParser(
        description="Config-driven multiclass training"
    ).with_standard_arguments(("batch-size", 16), "max-epochs",
                              "early-stopping-patience", "learning-rate")
    parser.add_argument("--dataset-config", default=os.path.join(
        CONFIG_DIR, "datasets", "training_example_data_sqlite.yml"))
    parser.add_argument("--model-config", default=os.path.join(
        CONFIG_DIR, "models", "dynedge_pid_classification.yml"))
    return add_device_arguments(parser).parse_args(argv)


def main(argv=None) -> Trainer:
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    args = parse_args(argv)
    model = load_model(args.model_config, device=args.device)
    config = TrainingConfig(
        target=list(model.target_labels),
        early_stopping_patience=args.early_stopping_patience,
        fit={"max_epochs": args.max_epochs},
        dataloader={"batch_size": args.batch_size},
    )
    datasets = load_dataset(args.dataset_config)
    train_loader = DataLoader(datasets["train"], shuffle=True, seed=args.seed,
                              **config.dataloader)
    val_loader = DataLoader(datasets["validation"], **config.dataloader)
    trainer = Trainer(model, learning_rate=args.learning_rate)
    trainer.fit(train_loader, val_loader,
                early_stopping_patience=config.early_stopping_patience,
                **config.fit)
    print_predictions(trainer, val_loader, config.target)
    return trainer


if __name__ == "__main__":
    main()
