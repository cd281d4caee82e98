"""PyTorch/CUDA port of graphnet-tpu.

Mirrors the module paths of the JAX package ``graphnet_tpu`` so that the
counterpart of each module is easy to find, and keeps its dense-padded
``[B, L, D]`` layout with a ``[B, L]`` validity mask.  The TPU's Pallas
kernels become CUDA C++ kernels for Hopper (``graphnet_tpu_torch/csrc``),
built on first use; every kernel has a plain PyTorch version beside it,
which is what runs for tensors on the CPU.

This package imports ``torch`` and ``numpy`` only (and pandas inside
the calls that read or return tables: a detector's geometry table,
``Trainer.predict_as_dataframe``; pyarrow inside the Parquet dataset's
calls).  Its host-side C++ (``csrc/host``: padding, the SQLite fetch) is
built by ``g++`` at first use (``native.py``).
"""

from graphnet_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
