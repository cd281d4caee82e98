"""Train a conditional NormalizingFlow for the energy density of the
bundled Prometheus events (counterpart of
``examples/03_training/06_train_normalizing_flow.py``).

    python -m graphnet_tpu_torch.examples.train_normalizing_flow --max-epochs 1
    python -m graphnet_tpu_torch.examples.train_normalizing_flow --device cpu

The flow learns p(log10 E | event): full-width DynEdge latents condition
a stack of affine + sinh-arcsinh transforms (``--transform spline`` for
rational-quadratic splines) trained on the exact NLLH.  After training
the script evaluates the density of the first events on a grid of 101
values.  It trains on the GPU unless ``--device cpu`` is given.
"""

from __future__ import annotations

import logging
import math
from typing import Dict

import numpy as np
import torch

from graphnet_tpu_torch.constants import EXAMPLE_SQLITE_DATA
from graphnet_tpu_torch.data.constants import FEATURES, TRUTH
from graphnet_tpu_torch.data.dataloader import DataLoader
from graphnet_tpu_torch.data.sqlite_dataset import SQLiteDataset
from graphnet_tpu_torch.examples.common import add_device_arguments
from graphnet_tpu_torch.models.detector.prometheus import Prometheus
from graphnet_tpu_torch.models.gnn.dynedge import DynEdge
from graphnet_tpu_torch.models.graphs import KNNGraph
from graphnet_tpu_torch.models.normalizing_flow import NormalizingFlow
from graphnet_tpu_torch.training.labels import Label
from graphnet_tpu_torch.training.trainer import Trainer
from graphnet_tpu_torch.utils.argparse import ArgumentParser

GRID = np.linspace(-1.0, 4.0, 101, dtype=np.float32)


class Log10Energy(Label):
    """log10 of ``total_energy``, the flow's target."""

    def __init__(self, key: str = "log10_energy"):
        super().__init__(key=key)

    def __call__(self, event):
        return np.log10(np.asarray(event.labels["total_energy"], np.float64)
                        ).astype(np.float32)


def parse_args(argv=None):
    parser = ArgumentParser(
        description="Train a conditional normalizing flow"
    ).with_standard_arguments(("batch-size", 16), "max-epochs",
                              "learning-rate")
    parser.add_argument("--path", default=EXAMPLE_SQLITE_DATA)
    parser.add_argument("--transform", default="sinh_arcsinh",
                        choices=("sinh_arcsinh", "spline"))
    return add_device_arguments(parser).parse_args(argv)


def build(args):
    """The dataset and the flow."""
    dataset = SQLiteDataset(
        path=args.path,
        graph_definition=KNNGraph(detector=Prometheus()),
        pulsemaps="total",
        features=FEATURES.PROMETHEUS,
        truth=TRUTH.PROMETHEUS,
        truth_table="mc_truth",
        labels={"log10_energy": Log10Energy()},
    )
    flow = NormalizingFlow(
        backbone=DynEdge(nb_inputs=4), nb_targets=1,
        target_labels=("log10_energy",), transform=args.transform,
        device=args.device,
    )
    return dataset, flow


def density_scan(flow, batch) -> np.ndarray:
    """``log p`` of every event of ``batch`` at each value of
    :data:`GRID`: ``[len(GRID), B]``."""
    flow.eval()
    batch = batch.to(next(flow.parameters()).device)
    B = batch.batch_size
    with torch.no_grad():
        return np.stack([
            flow.log_prob(batch, torch.full((B, 1), float(g),
                                            device=batch.x.device)).cpu().numpy()
            for g in GRID])


def main(argv=None) -> Dict[str, object]:
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    args = parse_args(argv)
    dataset, flow = build(args)
    trainer = Trainer(flow, learning_rate=args.learning_rate)
    loader = DataLoader(dataset, batch_size=args.batch_size, shuffle=True,
                        seed=args.seed)
    history = trainer.fit(loader, max_epochs=args.max_epochs)
    print("final mean NLLH:", history["train_loss"][-1])

    batch = next(iter(DataLoader(dataset, batch_size=4)))
    logp = density_scan(flow, batch)
    mode = GRID[np.argmax(logp[:, 0])]
    truth = math.log10(float(batch.labels["total_energy"][0]))
    print(f"event 0: density mode at log10(E)={mode:.2f}, truth {truth:.2f}")
    return {"trainer": trainer, "history": history, "log_prob": logp}


if __name__ == "__main__":
    main()
