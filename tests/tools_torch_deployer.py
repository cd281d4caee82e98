"""A ``Deployer`` of the PyTorch port over ``.npz`` event files, for
``tests/test_torch_serving.py``: importable by its spawned workers, so
it imports the port and numpy only."""

import os

import numpy as np
import torch

from graphnet_tpu_torch.deployment.deployer import Deployer
from graphnet_tpu_torch.models.graphs.graph_definition import Event


def write_events(path, arrays):
    """One ``.npz`` file of events: arrays ``e0``, ``e1``, ... of pulses."""
    np.savez(path, **{f"e{i}": a for i, a in enumerate(arrays)})


def read_events(path, features):
    with np.load(path) as f:
        return [Event(x=f[f"e{i}"], features=features) for i in range(len(f))]


class NpzDeployer(Deployer):
    """Serves each file's events in one call of the first module and
    writes the answers to ``<out_dir>/<file name>.npy``, on one torch
    thread (so every worker and the one-process run compute alike)."""

    def __init__(self, modules, n_workers, out_dir, features):
        super().__init__(modules, n_workers)
        self.out_dir = out_dir
        self.features = features

    def _process_files(self, settings):
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            module = self._modules[0]
            for path in settings:
                out = module(read_events(str(path), self.features))
                name = os.path.basename(str(path)) + ".npy"
                np.save(os.path.join(self.out_dir, name), out)
        finally:
            torch.set_num_threads(threads)


class FailingDeployer(Deployer):
    """A worker that exits with code 3."""

    def _process_files(self, settings):
        raise SystemExit(3)
