"""The recording a run replays and the two loops that feed it to the system.

- `Recording`: `slices` slices of the cell's slice size, generated from the
  seed by the traffic mix's scene, held in host memory (pinned on the card's
  machine). It is replayed in a loop; each pass shifts the times by the
  recording's span, so the stream's clock keeps rising.
- `replay`: a closed loop. Calls of `slices_per_call` slices, each handed
  from host memory to the system, its outputs moved back to host memory,
  as fast as the system goes.
- `live`: an open loop. Slice k is due when the sensor emits its last
  event, t0 + (k + 1) * slice_events / rate, on a schedule fixed before the
  window; one slice per call. A slice's latency runs from its due time to
  its outputs on the host, so a stall delays every slice queued behind it.
- `Checker`: which stretches of the window the reference recomputes (the
  limits file's `check`): the window's first slices from the stream's
  start, and stretches drawn from the seed, each from a copy of the
  system's state taken before it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from typing import Optional

import numpy as np
import torch


def seed_rng(seed: int, *stream: int) -> np.random.Generator:
    """A generator for `seed`, any whole number, and a stream tag."""
    return np.random.default_rng([int(seed) % 2**63, *stream])


def slice_us(cell) -> int:
    """µs per slice: the traffic's cadence, or the live rate's period."""
    tr = cell.traffic
    if tr["loop"] == "live":
        return max(1, round(1e6 * cell.config["slicing"]["n_events"] / tr["rate_events_per_s"]))
    return int(tr["slice_us"])


class Recording:
    """(S, N) slices of events from the scene; times in µs from 0."""

    def __init__(self, cell, seed: int, device: torch.device):
        cfg, tr = cell.config, cell.traffic
        self.s, self.n = tr["slices"], cfg["slicing"]["n_events"]
        self.slice_us = slice_us(cell)
        self.span = self.s * self.slice_us
        x, y, t = cell.scene_module().generate(
            seed_rng(seed, 1), self.s, self.n, self.slice_us,
            cfg["sensor"]["width"], cfg["sensor"]["height"], **tr.get("scene_params", {}))
        self.x, self.y, self.t = x, y, t
        xyt = torch.from_numpy(np.stack([x, y, t], 1).astype(np.int32))
        valid = torch.ones((self.s, self.n), dtype=torch.bool)
        if device.type == "cuda":
            xyt, valid = xyt.pin_memory(), valid.pin_memory()
        self.xyt, self.valid, self.device = xyt, valid, device

    def offset(self, g: int) -> int:
        return (g // self.s) * self.span

    def to_device(self, g: int, count: int):
        """Slices g .. g + count - 1 of the endless stream on the device, as
        (x, y, t, valid) of shape (count, N); they lie in one pass."""
        r = g % self.s
        xyt = self.xyt[r:r + count].to(self.device, non_blocking=True)
        valid = self.valid[r:r + count].to(self.device, non_blocking=True)
        return xyt[:, 0], xyt[:, 1], xyt[:, 2] + self.offset(g), valid

    def host(self, g: int):
        """Slice g as NumPy (x, y, t, valid), the reference's input."""
        r = g % self.s
        t = self.t[r].astype(np.int64) + self.offset(g)
        return (self.x[r].astype(np.int32), self.y[r].astype(np.int32),
                t.astype(np.int32), np.ones(self.n, bool))


@dataclasses.dataclass
class Chunk:
    start: int               # global index of its first slice
    length: int              # slices the reference recomputes
    snapshot: object         # the system's state before it; None: the stream's start
    outs: list = dataclasses.field(default_factory=list)   # per-slice host dicts
    traced: bool = False


class Checker:
    """Keeps the stretches the reference recomputes after the window.

    Chunk 0 is the window's first `check.first` slices from the stream's
    start; it is longer than a call, so it also holds the program to the
    state it carries from one call to the next. Chunks 1, 2, ... are
    `check.slices` slices each, starting at a call; `check.chunks - 1` of
    them are kept, drawn from the seed (reservoir sampling), plus the traced
    stretch's."""

    def __init__(self, check: dict, slices_per_call: int, seed: int):
        self.first, self.length = check["first"], check["slices"]
        self.calls0 = math.ceil(self.first / slices_per_call)
        self.calls = math.ceil(self.length / slices_per_call)
        self.others = check["chunks"] - 1
        self.rng = seed_rng(seed, 2)
        self.kept: dict = {}
        self.slots: list = []
        self.seen = 0

    def starts(self, i_call: int) -> bool:
        """Whether a chunk after the first starts at call i_call."""
        return i_call >= self.calls0 and (i_call - self.calls0) % self.calls == 0

    def chunk_start(self, i_call: int, g: int, system, state, force: bool = False) -> bool:
        """Called before every call; True where a chunk starts and is kept."""
        if i_call == 0:
            self.kept[0] = Chunk(g, self.first, None)
            return True
        if not self.starts(i_call):
            return False
        j = 1 + (i_call - self.calls0) // self.calls
        if not force:
            self.seen += 1
            if len(self.slots) < self.others:
                self.slots.append(j)
            else:
                r = int(self.rng.integers(0, self.seen))
                if r >= self.others:
                    return False
                self.kept.pop(self.slots[r], None)
                self.slots[r] = j
        self.kept[j] = Chunk(g, self.length, system.snapshot(state), traced=force)
        return True

    def collect(self, g: int, host: dict, count: int) -> None:
        for c in self.kept.values():
            for s in range(count):
                k = g + s - c.start
                if 0 <= k < c.length and k == len(c.outs):
                    c.outs.append({f: v[s] for f, v in host.items()})

    def chunks(self) -> list:
        return [c for _, c in sorted(self.kept.items()) if c.outs]


# the traced stretch: its chunk's calls, and at least this many slices
TRACE_SLICES = 32
# a live slice not served this long after the window closes counts as failed
GRACE_S = 60.0


def _nospan(_name):
    return contextlib.nullcontext()


@dataclasses.dataclass
class Window:
    """What the loop measured."""
    seconds: float                 # window start to last completion
    slices: int                    # slices whose outputs reached the host
    attempted: int
    failed: int
    latencies_s: list
    late_s: list
    end_state: object


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_calls(system, state, rec: Recording, spc: int, calls: int, device) -> object:
    """`calls` calls from the stream's start (set-up's warm-up)."""
    for i in range(calls):
        xs, ys, ts, vs = rec.to_device(i * spc, spc)
        state, out = system.step(state, xs, ys, ts, vs)
        system.host(out)
        system.snapshot(state)
    sync(device)
    return state


def replay(system, state, rec: Recording, seconds: float, spc: int, checker: Checker,
           tracer, device) -> Window:
    """Closed loop: calls back to back until `seconds` have passed."""
    span = tracer.span if tracer else _nospan
    if rec.s % spc:
        raise ValueError(f"slices_per_call {spc} does not divide the recording's {rec.s}")
    t0 = time.perf_counter()
    done, i, last = 0, 0, t0
    while last - t0 < seconds:
        g = i * spc
        force = (tracer is not None and checker.starts(i)
                 and tracer.wants(last - t0))
        checker.chunk_start(i, g, system, state, force)
        if force:
            tracer.start(max(checker.calls * spc, TRACE_SLICES))
        with span("events_in"):
            xs, ys, ts, vs = rec.to_device(g, spc)
        with span("step_call"):
            state, out = system.step(state, xs, ys, ts, vs)
        with span("outputs_out"):
            host = system.host(out)
        last = time.perf_counter()
        done += spc
        checker.collect(g, host, spc)
        if tracer is not None:
            tracer.after_slices(spc)
        i += 1
    return Window(seconds=last - t0, slices=done, attempted=done, failed=0,
                  latencies_s=[], late_s=[], end_state=state)


def live(system, state, rec: Recording, seconds: float, rate: float, checker: Checker,
         tracer, device) -> Window:
    """Open loop: slice k due at t0 + (k + 1) * N / rate; every slice due in
    the window is served, and one not served `GRACE_S` after the window is
    counted failed."""
    span = tracer.span if tracer else _nospan
    period = rec.n / rate
    due_n = int(seconds / period)
    t0 = time.perf_counter() + 0.001
    lat, late = [], []
    last = t0
    for k in range(due_n):
        due = t0 + (k + 1) * period
        now = time.perf_counter()
        if now - t0 > seconds + GRACE_S:
            break
        force = (tracer is not None and checker.starts(k)
                 and tracer.wants(now - t0))
        checker.chunk_start(k, k, system, state, force)
        if force:
            tracer.start(max(checker.calls, TRACE_SLICES))
        if now < due:
            with span("schedule_wait"):   # a spin, not a sleep: no wake-up to wait for
                while time.perf_counter() < due:
                    pass
        start = time.perf_counter()
        with span("events_in"):
            xs, ys, ts, vs = rec.to_device(k, 1)
        with span("step_call"):
            state, out = system.step(state, xs, ys, ts, vs)
        with span("outputs_out"):
            host = system.host(out)
        last = time.perf_counter()
        lat.append(last - due)
        late.append(start - due)
        checker.collect(k, host, 1)
        if tracer is not None:
            tracer.after_slices(1)
    served = len(lat)
    return Window(seconds=last - t0, slices=served, attempted=due_n,
                  failed=due_n - served, latencies_s=lat, late_s=late, end_state=state)


def end_to_end(window: Window, n_events: int) -> dict:
    """Every end-to-end quantity the loop can give, by metric name."""
    out = {}
    if window.latencies_s:
        lat_ms = np.asarray(window.latencies_s) * 1e3
        out["slice_latency_p50_ms"] = float(np.percentile(lat_ms, 50))
        out["slice_latency_p95_ms"] = float(np.percentile(lat_ms, 95))
    elif window.seconds > 0:
        out["events_per_s"] = window.slices * n_events / window.seconds
    return out


def schedule_lateness(window: Window) -> Optional[dict]:
    """How late the open loop started its slices, in ms."""
    if not window.late_s:
        return None
    late = np.asarray(window.late_s) * 1e3
    return dict(p50=float(np.percentile(late, 50)), p95=float(np.percentile(late, 95)),
                max=float(late.max()), started_late_share=float((late > 1.0).mean()))

