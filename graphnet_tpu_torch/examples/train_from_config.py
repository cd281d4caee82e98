"""Train a model defined by config files alone, with no model code in
the script (counterpart of ``examples/03_training/04_train_from_config.py``).

    python -m graphnet_tpu_torch.examples.train_from_config --max-epochs 1
    python -m graphnet_tpu_torch.examples.train_from_config --device cpu

The dataset config names its train and validation selections (one file,
two datasets); the model config builds the whole StandardModel.  The
Trainer writes ``best`` and ``last`` checkpoints to ``--output``, and
the script ``model.yml`` and ``state_dict.pkl`` beside them, which both
packages' ``DeploymentModule`` serve.  The model trains on the GPU
unless ``--device cpu`` is given.
"""

from __future__ import annotations

import logging
import os
import tempfile

from graphnet_tpu_torch.constants import GRAPHNET_ROOT_DIR
from graphnet_tpu_torch.data.dataloader import DataLoader
from graphnet_tpu_torch.examples.common import (
    add_device_arguments,
    print_predictions,
)
from graphnet_tpu_torch.training.trainer import Trainer
from graphnet_tpu_torch.utils.argparse import ArgumentParser
from graphnet_tpu_torch.utils.config import (
    load_dataset,
    load_model,
    save_model_config,
)

CONFIG_DIR = os.path.join(GRAPHNET_ROOT_DIR, "configs")


def parse_args(argv=None):
    parser = ArgumentParser(
        description="Train from dataset and model configs"
    ).with_standard_arguments(("batch-size", 16), "max-epochs",
                              "early-stopping-patience", "learning-rate")
    parser.add_argument("--dataset-config", default=os.path.join(
        CONFIG_DIR, "datasets", "training_example_data_sqlite.yml"))
    parser.add_argument("--model-config", default=os.path.join(
        CONFIG_DIR, "models", "dynedge_energy_prometheus.yml"))
    parser.add_argument("--output", default=os.path.join(
        tempfile.gettempdir(), "dynedge_from_config"))
    return add_device_arguments(parser).parse_args(argv)


def build(args):
    """The training and validation loaders and the model."""
    datasets = load_dataset(args.dataset_config)
    train_loader = DataLoader(datasets["train"], batch_size=args.batch_size,
                              shuffle=True, seed=args.seed)
    val_loader = DataLoader(datasets["validation"], batch_size=args.batch_size)
    model = load_model(args.model_config, device=args.device)
    return train_loader, val_loader, model


def train(args, train_loader, val_loader, model) -> Trainer:
    trainer = Trainer(model, learning_rate=args.learning_rate,
                      checkpoint_dir=args.output)
    trainer.fit(train_loader, val_loader, max_epochs=args.max_epochs,
                early_stopping_patience=args.early_stopping_patience)
    return trainer


def main(argv=None) -> Trainer:
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    args = parse_args(argv)
    train_loader, val_loader, model = build(args)
    trainer = train(args, train_loader, val_loader, model)
    print_predictions(trainer, val_loader, model.target_labels)
    save_model_config(model, os.path.join(args.output, "model.yml"))
    trainer.save_state_dict(os.path.join(args.output, "state_dict.pkl"))
    print(f"Saved best, last, model.yml and state_dict.pkl to {args.output}")
    return trainer


if __name__ == "__main__":
    main()
