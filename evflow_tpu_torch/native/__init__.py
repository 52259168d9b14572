"""Host C++ of the port, bound with ctypes: the OPTICS sweep
(`optics_sweep.cpp`) and the event readers (`evio.cpp`: the CSV reader, the
EVT3 / EVT2 / EVT2.1 payload decoders and the exact coordinate analyzer;
the counterparts of evflow_tpu/native/__init__.py's bindings).

g++ builds each source at first use into the repository's
`build/evflow_tpu_torch/` directory, never beside the source, under a file
name keyed by the hash of the source and flags: an edited source is
rebuilt, an unchanged one is loaded. A failed build raises; nothing falls
back (the JAX package's bindings return None there and its callers take
numpy). Nothing here runs at import time.
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
EVIO_SOURCE = Path(__file__).resolve().parent / "evio.cpp"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_libs = {}   # source stem -> loaded library

_I32, _I64, _P = ctypes.c_int32, ctypes.c_int64, ctypes.c_void_p
_DECODE = [_P, _I64, _P, _P, _P, _P, _I64]
# C signatures: (argtypes, restype) per entry point of each source
_SIGNATURES = {
    "optics_sweep": {"optics_sweep": ([_I64, _I64, _P, _P, _P, _P, _P], None),
                     "optics_sweep_f32": ([_I64, _I64, _P, _P, _P, _P, _P], None)},
    "evio": {"evio_load_csv": ([ctypes.c_char_p, _P, _P, _P, _P, _I64], _I64),
             "evio_decode_evt3": (_DECODE, _I64),
             "evio_decode_evt2": (_DECODE, _I64),
             "evio_decode_evt21": (_DECODE + [_I32], _I64),
             "evio_analyze_coordinates": ([_P, _P, _I64, _P, _P], _I64)},
}


def library_path(source: Path | None = None) -> Path:
    source = SOURCE if source is None else source
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(source.read_bytes())
    return BUILD_DIR / f"lib{source.stem}-{h.hexdigest()[:16]}.so"


def build(source: Path | None = None) -> Path:
    """Compile `source` (the sweep by default) unless it is built already;
    raise with g++'s output if it fails."""
    source = SOURCE if source is None else source
    out = library_path(source)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    r = subprocess.run(["g++", *FLAGS, str(source), "-o", str(tmp)],
                       capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed on {source.name}:\n{(r.stdout + r.stderr)[-4000:]}")
    os.replace(tmp, out)
    return out


def _load(source: Path) -> ctypes.CDLL:
    if source.stem not in _libs:
        with _lock:
            if source.stem not in _libs:
                so = ctypes.CDLL(str(build(source)))
                for name, (args, res) in _SIGNATURES[source.stem].items():
                    fn = getattr(so, name)
                    fn.argtypes, fn.restype = args, res
                _libs[source.stem] = so
    return _libs[source.stem]


def lib() -> ctypes.CDLL:
    """The sweep's library."""
    return _load(SOURCE)


def evio_lib() -> ctypes.CDLL:
    """The event readers' library."""
    return _load(EVIO_SOURCE)


def optics_sweep(nbr_idx: np.ndarray, nbr_dist: np.ndarray, core_dist: np.ndarray):
    """The OPTICS seed-queue sweep over an (N, K) table: (order int64,
    reach, -1 where unreached). A float32 table (distances and core
    distances both float32) is swept as it is, with float32 reach; any
    other is widened to float64, with float64 reach. The order, and the
    reach's values, are the same either way."""
    n, k = nbr_idx.shape
    if nbr_dist.shape != (n, k) or core_dist.shape != (n,):
        raise ValueError(f"table shapes {nbr_idx.shape}, {nbr_dist.shape}, {core_dist.shape}")
    f32 = nbr_dist.dtype == np.float32 and core_dist.dtype == np.float32
    ftype = np.float32 if f32 else np.float64
    nbr_idx = np.ascontiguousarray(nbr_idx, np.int32)
    nbr_dist = np.ascontiguousarray(nbr_dist, ftype)
    core = np.ascontiguousarray(core_dist, ftype)
    if n and (int(nbr_idx.max(initial=-1)) >= n):
        raise ValueError("neighbor index out of range")
    order = np.empty(n, np.int64)
    reach = np.empty(n, ftype)
    fn = lib().optics_sweep_f32 if f32 else lib().optics_sweep
    fn(n, k, nbr_idx.ctypes.data, nbr_dist.ctypes.data, core.ctypes.data,
       order.ctypes.data, reach.ctypes.data)
    return order, reach


def _event_buffers(capacity: int):
    return (np.empty(capacity, np.int32), np.empty(capacity, np.int32),
            np.empty(capacity, np.int64), np.empty(capacity, np.int32))


def _decoded(fn, payload: bytes, capacity: int, *extra):
    """Run one decoder over `payload` into buffers of `capacity` events:
    (x int32, y int32, t int64, p int32) of the events decoded."""
    bufs = _event_buffers(max(capacity, 1))
    n = fn(payload, len(payload), *(b.ctypes.data for b in bufs), capacity, *extra)
    return tuple(b[:n].copy() for b in bufs)


def load_csv(path: str, capacity: int = 1 << 24):
    """Parse "x,y[,t[,p]]" rows: (x, y, t, p) numpy arrays; rows beyond
    `capacity` are dropped."""
    bufs = _event_buffers(capacity)
    n = evio_lib().evio_load_csv(os.fsencode(path), *(b.ctypes.data for b in bufs), capacity)
    if n < 0:
        raise FileNotFoundError(path)
    return tuple(b[:n].copy() for b in bufs)


def decode_evt3(payload: bytes, capacity: int | None = None):
    """EVT3 payload decode -> (x, y, t, p). `capacity` defaults to the exact
    event count: single-event words plus the set bits of the vector words'
    validity masks."""
    if len(payload) % 2:
        payload = payload[:-1]
    if capacity is None:
        w = np.frombuffer(payload, dtype="<u2")
        typ = w >> 12
        vec = (typ == 0x4) | (typ == 0x5)
        capacity = int(np.sum(typ == 0x2)) + int(
            np.sum(np.unpackbits((w[vec] & 0xFFF).astype(">u2").view(np.uint8))))
    return _decoded(evio_lib().evio_decode_evt3, payload, capacity)


def decode_evt2(payload: bytes):
    """EVT2 payload decode -> (x, y, t, p)."""
    payload = payload[:len(payload) - len(payload) % 4]
    w = np.frombuffer(payload, dtype="<u4")
    return _decoded(evio_lib().evio_decode_evt2, payload, int(np.sum((w >> 28) <= 1)))


def decode_evt21(payload: bytes, swapped_halves: bool = False):
    """EVT2.1 payload decode -> (x, y, t, p); `swapped_halves` reads words
    whose 32-bit halves were written in the other order."""
    payload = payload[:len(payload) - len(payload) % 8]
    w = np.frombuffer(payload, dtype="<u8")
    if swapped_halves:
        w = (w << np.uint64(32)) | (w >> np.uint64(32))
    cd = w[(w >> np.uint64(60)) <= 1]
    capacity = int(np.sum(np.unpackbits(
        (cd & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.uint8))))
    return _decoded(evio_lib().evio_decode_evt21, payload, capacity, int(swapped_halves))


def analyze_coordinates(xs: np.ndarray, ys: np.ndarray):
    """The unique (x, y) in first-occurrence order (the exact CPU dedup
    oracle): (ux, uy) int32 arrays."""
    xs = np.ascontiguousarray(xs, np.int32)
    ys = np.ascontiguousarray(ys, np.int32)
    ux = np.empty(len(xs), np.int32)
    uy = np.empty(len(xs), np.int32)
    cnt = evio_lib().evio_analyze_coordinates(xs.ctypes.data, ys.ctypes.data, len(xs),
                                              ux.ctypes.data, uy.ctypes.data)
    return ux[:cnt].copy(), uy[:cnt].copy()
