"""Build and load the port's CUDA kernels.

Each ``graphnet_tpu_torch/csrc/<name>.cu`` is compiled by ``nvcc`` into
its own shared library with a plain C interface and loaded with
``ctypes``.  Builds happen at first use, into ``graphnet_tpu_torch/_build``
(listed in ``.gitignore``), under a file lock so concurrent processes
are safe.  The library's file name carries a hash of the source and the
flags, so an edited source is rebuilt.

Nothing here runs at import time: the CPU tests import every module on
machines with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-lineinfo", "-Xptxas", "-v",
)

_loaded: Dict[str, ctypes.CDLL] = {}
_load_lock = threading.Lock()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin); the CUDA "
        "kernels can only be built on a machine with the CUDA toolkit"
    )


def _library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for extra in sorted(CSRC.glob("*.cuh")):
        h.update(extra.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str) -> "subprocess.Popen | None":
    """Start the compile of ``name`` unless its library exists."""
    so = _library_path(name)
    if so.exists():
        return None
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    return subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile the named kernels, all ``nvcc`` processes at once.

    Returns each kernel's compiler log (ptxas register and spill report
    included); for a library built before, the log kept beside it ("" if
    there is none).  Raises ``RuntimeError`` if a compile fails.
    """
    names = list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    logs: Dict[str, str] = {}
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            procs = {n: _start(n) for n in names}
            failed: List[str] = []
            for n, proc in procs.items():
                if proc is None:
                    log = _library_path(n).with_suffix(".log")
                    logs[n] = log.read_text() if log.exists() else ""
                    continue
                out, _ = proc.communicate()
                logs[n] = out
                so = _library_path(n)
                tmp = so.with_suffix(f".{os.getpid()}.tmp")
                if proc.returncode != 0:
                    failed.append(f"{n}:\n{out}")
                    tmp.unlink(missing_ok=True)
                else:
                    os.replace(tmp, so)
                    (BUILD_DIR / f"{so.stem}.log").write_text(out)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    with _load_lock:
        lib = _loaded.get(name)
        if lib is None:
            so = _library_path(name)
            if not so.exists():
                build([name])
            lib = ctypes.CDLL(str(so))
            _loaded[name] = lib
        return lib
