"""Host C++ of the port, bound with ctypes: the OPTICS sweep
(`optics_sweep.cpp`).

g++ builds it at first use into the repository's `build/evflow_tpu_torch/`
directory, never beside the source, under a file name keyed by the hash of
the source and flags: an edited source is rebuilt, an unchanged one is
loaded. A failed build raises; nothing falls back. Nothing here runs at
import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from ..kernels import BUILD_DIR

SOURCE = Path(__file__).resolve().parent / "optics_sweep.cpp"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib = None

_I64, _P = ctypes.c_int64, ctypes.c_void_p


def library_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"liboptics_sweep-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile optics_sweep.cpp unless it is built already; raise with g++'s
    output if it fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    r = subprocess.run(["g++", *FLAGS, str(SOURCE), "-o", str(tmp)],
                       capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed on {SOURCE.name}:\n{(r.stdout + r.stderr)[-4000:]}")
    os.replace(tmp, out)
    return out


def lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                so = ctypes.CDLL(str(build()))
                so.optics_sweep.argtypes = [_I64, _I64, _P, _P, _P, _P, _P]
                so.optics_sweep.restype = None
                _lib = so
    return _lib


def optics_sweep(nbr_idx: np.ndarray, nbr_dist: np.ndarray, core_dist: np.ndarray):
    """The OPTICS seed-queue sweep over an (N, K) table: (order int64,
    reach float64, -1 where unreached)."""
    n, k = nbr_idx.shape
    if nbr_dist.shape != (n, k) or core_dist.shape != (n,):
        raise ValueError(f"table shapes {nbr_idx.shape}, {nbr_dist.shape}, {core_dist.shape}")
    nbr_idx = np.ascontiguousarray(nbr_idx, np.int32)
    nbr_dist = np.ascontiguousarray(nbr_dist, np.float64)
    core = np.ascontiguousarray(core_dist, np.float64)
    if n and (int(nbr_idx.max(initial=-1)) >= n):
        raise ValueError("neighbor index out of range")
    order = np.empty(n, np.int64)
    reach = np.empty(n, np.float64)
    lib().optics_sweep(n, k, nbr_idx.ctypes.data, nbr_dist.ctypes.data, core.ctypes.data,
                       order.ctypes.data, reach.ctypes.data)
    return order, reach
