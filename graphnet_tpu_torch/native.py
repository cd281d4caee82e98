"""ctypes bindings of the host-side native code (counterpart of
``graphnet_tpu/native.py``).

Two C++ sources under ``graphnet_tpu_torch/csrc/host``: ``collate.cpp``
(the DataLoader's padding loop) and ``sqlite_fetch.cpp`` (the SQLite
dataset's batched fetch, straight into a float64 buffer; linked against
``libsqlite3.so.0``).  Each is compiled by ``g++ -O3 -shared -fPIC`` at
first use into ``graphnet_tpu_torch/_build`` (gitignored), named by a
hash of its source and flags, under the kernels' build lock
(``kernels/build.py``).  Nothing is built at import.

Where a library cannot be built or loaded (no compiler, no
``libsqlite3``), the functions return None and the callers take the
numpy / ``sqlite3`` routes, as in the JAX package.  Each native route
counts its calls (``native_pad_events.calls``, ...), so a run can show
that it went through them.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from graphnet_tpu_torch.kernels.build import BUILD_DIR

HOST_SRC = Path(__file__).resolve().parent / "csrc" / "host"
GXX_FLAGS = ("-O3", "-shared", "-fPIC")
# source file and libraries to link, by library name
SOURCES: Dict[str, Tuple[str, Tuple[str, ...]]] = {
    "collate": ("collate.cpp", ()),
    "sqlite_fetch": ("sqlite_fetch.cpp", ("-l:libsqlite3.so.0",)),
}

_libs: Dict[str, Optional[ctypes.CDLL]] = {}
_lock = threading.Lock()
_count_lock = threading.Lock()


def _count(fn) -> None:
    with _count_lock:
        fn.calls += 1


def library_path(name: str) -> Path:
    """Where library ``name`` is (or will be) built."""
    src, libs = SOURCES[name]
    h = hashlib.sha256((HOST_SRC / src).read_bytes())
    h.update(" ".join(GXX_FLAGS + libs).encode())
    return BUILD_DIR / f"host_{name}-{h.hexdigest()[:16]}.so"


def gxx_version() -> Optional[str]:
    """The first line of ``g++ --version``; None without a compiler."""
    try:
        out = subprocess.run(["g++", "--version"], capture_output=True,
                             text=True, timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.splitlines()[0] if out else None


def _build(name: str) -> Optional[Path]:
    """Compile library ``name`` unless it exists; None if ``g++`` fails."""
    so = library_path(name)
    if so.exists():
        return so
    src, libs = SOURCES[name]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if so.exists():  # built by another process meanwhile
                return so
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            try:
                subprocess.run(
                    ["g++", *GXX_FLAGS, "-o", str(tmp),
                     str(HOST_SRC / src), *libs],
                    check=True, capture_output=True, timeout=120)
            except (OSError, subprocess.SubprocessError):
                tmp.unlink(missing_ok=True)
                return None
            os.replace(tmp, so)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return so


def _declare(name: str, lib: ctypes.CDLL) -> None:
    # pointers as c_void_p: without argtypes ctypes cuts them to 32 bits
    if name == "collate":
        lib.pad_events.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.pad_events.restype = None
        lib.pad_node_labels.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p,
        ]
        lib.pad_node_labels.restype = None
    else:
        lib.gn_sqlite_open.argtypes = [ctypes.c_char_p]
        lib.gn_sqlite_open.restype = ctypes.c_void_p
        lib.gn_sqlite_close.argtypes = [ctypes.c_void_p]
        lib.gn_sqlite_close.restype = None
        lib.gn_sqlite_fetch_f64.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_int32,
        ]
        lib.gn_sqlite_fetch_f64.restype = ctypes.c_longlong


def get_lib(name: str = "collate") -> Optional[ctypes.CDLL]:
    """The loaded library ``name`` (``"collate"`` or ``"sqlite_fetch"``),
    built first if needed; None if it cannot be built or loaded (tried
    once a process)."""
    if name in _libs:
        return _libs[name]
    with _lock:
        if name not in _libs:
            lib = None
            so = _build(name)
            if so is not None:
                try:
                    lib = ctypes.CDLL(str(so))
                    _declare(name, lib)
                except OSError:
                    lib = None
            _libs[name] = lib
    return _libs[name]


# -- SQLite ---------------------------------------------------------------
def sqlite_open(path: str) -> Optional[int]:
    """A native read-only connection handle, or None if unavailable."""
    lib = get_lib("sqlite_fetch")
    if lib is None:
        return None
    return lib.gn_sqlite_open(path.encode()) or None


def sqlite_close(handle: Optional[int]) -> None:
    if handle:
        lib = get_lib("sqlite_fetch")
        if lib is not None:
            lib.gn_sqlite_close(handle)


def sqlite_fetch_f64(
    handle: int, sql: str, ncols: int, cap_hint: int = 4096
) -> Optional[np.ndarray]:
    """Run ``sql`` natively: a ``[n, ncols]`` float64 array.

    None where a cell is not numeric (NULL, TEXT, BLOB) or the query
    fails: the caller then takes the ``sqlite3`` route.  A result larger
    than ``cap_hint`` rows is fetched once more into a buffer of its
    exact size.  The C call runs without the GIL; each call adds one to
    ``sqlite_fetch_f64.calls``.
    """
    lib = get_lib("sqlite_fetch")
    if lib is None:
        return None
    sql_b = sql.encode()
    cap = max(int(cap_hint), 16)
    for _ in range(2):
        out = np.empty((cap, ncols), np.float64)
        _count(sqlite_fetch_f64)
        n = lib.gn_sqlite_fetch_f64(handle, sql_b, out.ctypes.data, cap, ncols)
        if n >= 0:
            return out[:n]
        if n <= -3:  # the buffer was too small: once more at the exact size
            cap = -n - 3
            continue
        return None
    return None


sqlite_fetch_f64.calls = 0


# -- padding --------------------------------------------------------------
def _pointers(arrays: Sequence[np.ndarray]):
    return (ctypes.c_void_p * len(arrays))(*[a.ctypes.data for a in arrays])


def native_pad_events(
    events: List[np.ndarray], L: int
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """``[n_i, D]`` arrays padded in C++ to ``([B, L, D] float32, [B, L]
    bool, [B] int32)``, as ``batch.pad_events`` does with numpy (events
    longer than L truncated); None if the library is unavailable.  Each
    call adds one to ``native_pad_events.calls``."""
    lib = get_lib("collate")
    if lib is None or not events:
        return None
    B, D = len(events), events[0].shape[1]
    contig = [np.ascontiguousarray(e, dtype=np.float32) for e in events]
    if L < 0 or any(e.ndim != 2 or e.shape[1] != D for e in contig):
        raise ValueError("events must be [n_i, D] arrays of one D, L >= 0")
    lengths = np.asarray([e.shape[0] for e in contig], np.int32)
    out_x = np.empty((B, L, D), np.float32)
    out_mask = np.empty((B, L), np.uint8)
    out_n = np.empty((B,), np.int32)
    _count(native_pad_events)
    lib.pad_events(
        _pointers(contig),
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        B, D, L, out_x.ctypes.data, out_mask.ctypes.data, out_n.ctypes.data,
    )
    return out_x, out_mask.view(bool), out_n


native_pad_events.calls = 0


def native_pad_node_labels(
    labels: List[np.ndarray], L: int
) -> Optional[np.ndarray]:
    """Per-node label vectors padded in C++ to ``[B, L]`` float32 (longer
    ones truncated); None if the library is unavailable.  Each call adds
    one to ``native_pad_node_labels.calls``."""
    lib = get_lib("collate")
    if lib is None or not labels:
        return None
    if L < 0:
        raise ValueError("L must be >= 0")
    contig = [np.ascontiguousarray(np.asarray(v).reshape(-1), np.float32)
              for v in labels]
    lengths = np.asarray([len(v) for v in contig], np.int32)
    out = np.empty((len(contig), L), np.float32)
    _count(native_pad_node_labels)
    lib.pad_node_labels(
        _pointers(contig),
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        len(contig), L, out.ctypes.data,
    )
    return out


native_pad_node_labels.calls = 0
