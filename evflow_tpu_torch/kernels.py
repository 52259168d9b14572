"""Build, load and launch the port's CUDA kernels.

All sources in `csrc/` are compiled by nvcc for sm_90a, one nvcc process
per source, all started together, and linked into ONE shared library with a
plain C interface (no PyTorch headers, so a build takes seconds), loaded
with ctypes. The build runs at first use, into the repository's `build/`
directory, under a file name keyed by the hash of the sources and flags: an
edited source is rebuilt, an unchanged one is loaded.

Each C entry point launches on the stream it is given and returns
`cudaGetLastError()`; `launch` raises on a nonzero code and counts the
launch. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("efast_stencil.cu", "assign_manhattan.cu", "cluster_stats.cu",
           "aeclustering_exact.cu")
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "evflow_tpu_torch"
GENCODE = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*GENCODE, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signatures, without the trailing stream pointer every entry point takes
_SIGNATURES = {
    # sae, h, w, active, nb, nwt, band, wtile, border, sensor_w, sensor_h,
    # s3min, s3max, s4min, s4max, transpose, out
    "efast_stencil": [_P, _I, _I, _P, _I, _I, _I, _I, _I, _I, _I,
                      _I, _I, _I, _I, _I, _P],
    # x, y, n, mu, alive, c, radius, labels, dist
    "assign_manhattan": [_P, _P, _I, _P, _P, _I, _F, _P, _P],
    # labels, x, y, n, c, alpha, out
    "cluster_stats": [_P, _P, _P, _I, _I, _F, _P],
    # scal, ev, ring_in, ivec, mu_in, m, c, radius, alpha, one_minus,
    # ring_out, ivec_out, mu_out, scal_out
    "aeclustering_exact": [_P, _P, _P, _P, _P, _I, _I, _F, _F, _F, _P, _P, _P, _P],
}

# Launches per kernel. A wrapper adds one where it launches its kernel and
# nowhere else, so a run can show that the main path went through each.
LAUNCHES = {name: 0 for name in _SIGNATURES}

_lock = threading.Lock()
_lib = None


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(cuda_home, "bin", "nvcc")] if cuda_home else []
    candidates += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in SOURCES:
        h.update((CSRC / s).read_bytes())
    return BUILD_DIR / f"libevflow_kernels-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile csrc/*.cu into the shared library unless it is built already:
    one nvcc per source in parallel, then one link. nvcc's output (including
    ptxas register/shared-memory use) is kept beside the library as a .log
    file."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{Path(s).stem}.o" for s in SOURCES]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(CSRC / s)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for s, o in zip(SOURCES, objs)]
    logs = [p.communicate()[0] for p in procs]
    tmp = out.with_name(f"{tag}.tmp.so")
    failed = [s for s, p in zip(SOURCES, procs) if p.returncode != 0]
    if not failed:
        link = subprocess.run([nvcc, *GENCODE, "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        logs.append(link.stdout + link.stderr)
        if link.returncode != 0:
            failed = ["link"]
    for o in objs:
        o.unlink(missing_ok=True)
    out.with_suffix(".log").write_text("".join(logs))
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n{''.join(logs)[-4000:]}")
    os.replace(tmp, out)
    return out


def lib() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            so = ctypes.CDLL(str(build()))
            for name, args in _SIGNATURES.items():
                fn = getattr(so, name)
                fn.argtypes = args + [_P]
                fn.restype = ctypes.c_int
            _lib = so
    return _lib


def launch(name: str, *args) -> None:
    """Launch kernel `name` on PyTorch's current stream; raise if the launch
    failed, else count it."""
    rc = getattr(lib(), name)(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")
    LAUNCHES[name] += 1


def check_device(*tensors: torch.Tensor) -> str:
    """The common device type of `tensors`: 'cpu' (plain version) or 'cuda'
    (kernel); anything else raises."""
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"tensors on different devices: {dev} vs {t.device}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type


def check(t: torch.Tensor, name: str, dtype: torch.dtype, shape) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
