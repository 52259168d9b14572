"""The port's span API (counterpart of evflow_tpu/utils/profiling.py).

`span(name)`, or the decorator `spanned(name)`, marks a stretch of the
program's host work: the whole of a slice, a module's call (dedup,
fastcluster, sae, candidates, efast, nms, tracker, exact_engine, dbscan,
optics), a path or stage inside one (`dbscan.dense`, DBSCAN's dense pass
in a slice; `optics.table`, `optics.sweep` and `optics.extract`), or
one round of a host-checked fixpoint (`nms.round`,
`tracker.associate.round`, `tracker.group_seeds.round`, `dbscan.round`),
so the count of round spans is the round count. While a `torch.profiler`
session records, a span is a `record_function` range and lands in the
same trace as the CUDA kernels, on the same clock; otherwise it is one
shared no-op context. It adds no device sync and reads no tensor.

`trace(log_dir)` records CPU (and, with a card, CUDA) activity over a block
and writes it as a Chrome trace (open it in chrome://tracing or Perfetto).
"""

from __future__ import annotations

import contextlib
import functools
import os

import torch

_OFF = contextlib.nullcontext()
_recording = torch._C._autograd._profiler_enabled


def span(name: str):
    """A profiler range named `name` while a profiler records, else the
    shared no-op context."""
    if _recording():
        return torch.profiler.record_function(name)
    return _OFF


def spanned(name: str):
    """Decorator: every call of the function runs inside `span(name)`."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


@contextlib.contextmanager
def trace(log_dir: str):
    """Record CPU (and, with a card, CUDA) activity over the block and write
    it to `log_dir/trace.json` as a Chrome trace."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
