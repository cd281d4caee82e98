"""Deployer: shard input files across worker processes (counterpart of
``graphnet_tpu/deployment/deployer.py``).

Experiment-specific subclasses implement ``_process_files``, which runs
the modules over one shard of files.  The JAX package forks its workers;
a fork after CUDA is initialised leaves the child a broken CUDA context,
so the port starts them with the ``spawn`` method: each worker unpickles
the deployer in a fresh interpreter (a ``DeploymentModule`` built from a
``model.yml`` and a ``state_dict.pkl`` is built anew there from those
files).  A worker that exits with an error fails :meth:`Deployer.run`.
"""

from __future__ import annotations

import logging
import multiprocessing
import time
from typing import List, Sequence

import numpy as np

logger = logging.getLogger(__name__)


class Deployer:
    """Run DeploymentModules over files, optionally in parallel."""

    def __init__(self, modules: Sequence, n_workers: int = 1):
        self._modules = list(modules)
        self._n_workers = n_workers

    def _process_files(self, settings) -> None:  # pragma: no cover - interface
        raise NotImplementedError

    def _prepare_settings(self, input_files: List[str]) -> List[List[str]]:
        """Shard the files evenly across the workers."""
        shards = np.array_split(np.asarray(input_files), self._n_workers)
        return [list(s) for s in shards if len(s)]

    def run(self, input_files: List[str]) -> None:
        start = time.time()
        settings = self._prepare_settings(input_files)
        if len(settings) > 1:
            ctx = multiprocessing.get_context("spawn")
            processes = [ctx.Process(target=self._process_files, args=(shard,))
                         for shard in settings]
            for p in processes:
                p.start()
            for p in processes:
                p.join()
            failed = [p.exitcode for p in processes if p.exitcode != 0]
            if failed:
                raise RuntimeError(
                    f"{len(failed)} of {len(processes)} deployer workers "
                    f"failed (exit codes {failed})"
                )
        else:
            for shard in settings:
                self._process_files(shard)
        logger.info("Processed %d files in %.1fs", len(input_files),
                    time.time() - start)
