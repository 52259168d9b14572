"""Profiling & observability (counterpart of evflow_tpu/utils/profiling.py).

The reference's three ad-hoc mechanisms become:
  - Stopwatch (optics/Stopwatch.hpp)            -> Stopwatch (perf_counter laps)
  - OpenCL event profiling (`Total time = ns`)  -> stage_timer, a
    torch.profiler span (`record_function`) around a wall-clock timer
  - per-slice events/s printf counters          -> ThroughputMeter
`trace` records CPU and CUDA activity with torch.profiler and writes a
Chrome trace (open it in chrome://tracing or Perfetto).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, List, Optional

import torch


class Stopwatch:
    """restart/lap/elapsed in seconds (Stopwatch.hpp:13-60)."""

    def __init__(self):
        self.restart()

    def restart(self) -> None:
        self._start = time.perf_counter()
        self._laps: List[float] = []
        self._last = self._start

    def lap(self) -> float:
        now = time.perf_counter()
        d = now - self._last
        self._laps.append(d)
        self._last = now
        return d

    def elapsed(self) -> float:
        return time.perf_counter() - self._start

    def elapsed_laps(self) -> List[float]:
        return list(self._laps)


@contextlib.contextmanager
def stage_timer(name: str, sink: Optional[Dict[str, float]] = None,
                sync: bool = False):
    """Wall-time a pipeline stage, as a named span in torch.profiler traces
    too. The card runs its work asynchronously: with `sync` the timer ends
    after torch.cuda.synchronize(), so the stage's queued card work is in
    its time (where a card is present)."""
    with torch.profiler.record_function(name):
        t0 = time.perf_counter()
        yield
        if sync and torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    if sink is not None:
        sink[name] = sink.get(name, 0.0) + dt


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


class ThroughputMeter:
    """events/s counter — the engine's first-class metric."""

    def __init__(self):
        self.events = 0
        self.slices = 0
        self._sw = Stopwatch()

    def add_slice(self, n_events: int) -> None:
        self.events += int(n_events)
        self.slices += 1

    @property
    def events_per_s(self) -> float:
        dt = self._sw.elapsed()
        return self.events / dt if dt > 0 else 0.0

    def report(self) -> str:
        return json.dumps({
            "events": self.events, "slices": self.slices,
            "elapsed_s": round(self._sw.elapsed(), 4),
            "events_per_s": round(self.events_per_s, 1),
        })
