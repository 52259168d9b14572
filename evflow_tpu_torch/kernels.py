"""Build, load and launch the port's CUDA kernels.

All sources in `csrc/` are compiled by nvcc for sm_90a, one nvcc process
per source, all started together, and linked into ONE shared library with a
plain C interface (no PyTorch headers, so a build takes seconds), loaded
with ctypes. The build runs at first use, into the repository's `build/`
directory, under a file name keyed by the hash of the sources and flags: an
edited source is rebuilt, an unchanged one is loaded.

Each C entry point launches on the stream it is given and returns
`cudaGetLastError()`; `launch` raises on a nonzero code and counts the
launch. The ctypes functions are resolved once, when the library is
loaded, so a launch costs a dictionary lookup, the current stream's handle
(`torch.accelerator.current_stream(device).native_handle`, the cheapest
public way: it measured faster than `torch.cuda.current_stream()
.cuda_stream`, PERF.md section 6) and the ctypes call.
`launch_floor` launches an empty kernel at a given grid, for timing
(csrc/launch_floor.cu), and counts nothing. Nothing here runs at import
time.
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
SOURCES = ("efast_stencil.cu", "efast_ring.cu", "assign_manhattan.cu", "cluster_stats.cu",
           "aeclustering_exact.cu", "dbscan_eps.cu", "rep_candidates.cu", "launch_floor.cu")
HEADERS = ("efast_streak.cuh",)   # included by sources; part of the library's hash
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
    # sae, q, h, w, x, y, valid, m, border, sensor_w, sensor_h,
    # s3min, s3max, s4min, s4max, transpose, out
    "efast_ring": [_P, _I, _I, _I, _P, _P, _P, _I, _I, _I, _I,
                   _I, _I, _I, _I, _I, _P],
    # x, y, n, mu, alive, c, radius, labels, dist
    "assign_manhattan": [_P, _P, _I, _P, _P, _I, _F, _P, _P],
    # labels, x, y, n, c, alpha, k_after (null: none), out
    "cluster_stats": [_P, _P, _P, _I, _I, _F, _P, _P],
    # scal, ev, ring_in, ivec, mu_in, m, c, radius, alpha, one_minus,
    # ring_out, ivec_out, mu_out, scal_out
    "aeclustering_exact": [_P, _P, _P, _P, _P, _I, _I, _F, _F, _F, _P, _P, _P, _P],
    # rows, m, points, n, d, eps2, pflag, plabel (null: count mode), rflag, rlabel, out
    "dbscan_eps": [_P, _I, _P, _I, _I, _F, _P, _P, _P, _P, _P],
    # x, y, valid, r, n, m, w1, off, workspace (null: shared memory), cx, cy,
    # cvalid, n_dropped
    "rep_candidates": [_P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P],
    # blocks, threads, cluster
    "launch_floor": [_I, _I, _I],
}

# Launches per kernel. A wrapper adds one where it launches its kernel and
# nowhere else, so a run can show that the main path went through each.
LAUNCHES = {name: 0 for name in _SIGNATURES if name != "launch_floor"}

_lock = threading.Lock()
_lib = None
_fns = {}   # name -> ctypes function, filled when the library is loaded


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
    for s in SOURCES + HEADERS:
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
    if _lib is None:
        with _lock:
            if _lib is None:
                so = ctypes.CDLL(str(build()))
                for name, args in _SIGNATURES.items():
                    fn = getattr(so, name)
                    fn.argtypes = args + [_P]
                    fn.restype = ctypes.c_int
                    _fns[name] = fn
                _lib = so
    return _lib


def _call(name: str, device: int, args) -> None:
    fn = _fns.get(name)
    if fn is None:
        lib()
        fn = _fns[name]
    rc = fn(*args, torch.accelerator.current_stream(device).native_handle)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


def launch(name: str, device: int, *args) -> None:
    """Launch kernel `name` on PyTorch's current stream of CUDA device
    `device` (an index); raise if the launch failed, else count it."""
    _call(name, device, args)
    LAUNCHES[name] += 1


def launch_floor(blocks: int, threads: int, cluster: int = 1) -> None:
    """Launch the empty kernel on the current device at a grid of `blocks`
    CTAs of `threads` threads, in thread-block clusters of `cluster` CTAs;
    not counted."""
    _call("launch_floor", torch.cuda.current_device(), (blocks, threads, cluster))


def check_device(*tensors: torch.Tensor) -> int:
    """The common device of `tensors`: -1 for the CPU (plain version), else
    the CUDA device's index (kernel); anything else raises."""
    index = tensors[0].get_device()
    for t in tensors:
        if t.get_device() != index or not (t.is_cuda or t.is_cpu):
            raise ValueError("tensors on different or unsupported devices: "
                             f"{[str(u.device) for u in tensors]}")
    return index


def check(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple) -> None:
    """Raise unless `t` has this dtype and shape and is contiguous; one
    test on the path that passes."""
    if t.dtype == dtype and t.shape == shape and t.is_contiguous():
        return
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.shape != shape:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    raise ValueError(f"{name}: not contiguous")
