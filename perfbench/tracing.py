"""The traced run: `torch.profiler` over one stretch of the window, and what
the per-layer readers and the breakdown read from its trace.

The stretch is one checked chunk (`loops.Checker`), so the reference's
counts cover its slices. The harness's own spans name the host's activity
around each call: `events_in` (host to device), `step_call` (the system),
`outputs_out` (device to host), `schedule_wait` (the open loop waiting for
the next slice). The Chrome trace of the stretch is written into the
checkout's `perfbench_out/` and read back.
"""

from __future__ import annotations

import bisect
import contextlib
import json
from pathlib import Path
from typing import Optional

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
SPANS = ("events_in", "step_call", "outputs_out", "schedule_wait")
LAUNCH_PREFIXES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchCooperativeKernel")
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
              "cudaMemcpy", "cuStreamSynchronize", "cuCtxSynchronize", "cuMemcpyDtoH_v2")


class Tracer:
    """Profiles the first checked chunk that starts `after_s` into the window."""

    def __init__(self, out: Path, after_s: float, device: torch.device):
        self.out, self.after_s, self.device = out, after_s, device
        self.prof = None
        self.done = False
        self.left = 0
        self.slices = 0
        self.data: Optional[TraceData] = None
        self._stretch = None

    def wants(self, elapsed_s: float) -> bool:
        return not self.done and self.prof is None and elapsed_s >= self.after_s

    def span(self, name: str):
        if self.prof is None:
            return contextlib.nullcontext()
        return torch.profiler.record_function(name)

    def start(self, slices: int) -> None:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        self._stretch = torch.profiler.record_function("stretch")
        self._stretch.__enter__()
        self.left = slices

    def after_slices(self, count: int) -> None:
        if self.prof is None:
            return
        self.slices += count
        self.left -= count
        if self.left <= 0:
            self.stop()

    def stop(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._stretch.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        self.out.parent.mkdir(parents=True, exist_ok=True)
        self.prof.export_chrome_trace(str(self.out))
        self.prof = None
        self.done = True
        self.data = TraceData.load(self.out)


class TraceData:
    """The stretch's events, times in µs."""

    def __init__(self, events: list):
        xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
        stretch = [e for e in xs if e.get("cat") == "user_annotation"
                   and e["name"] == "stretch"]
        if not stretch:
            raise ValueError("trace holds no stretch span")
        s = stretch[0]
        self.t0, self.t1 = float(s["ts"]), float(s["ts"]) + float(s["dur"])
        self.main_tid = s.get("tid")

        def inside(e):
            return self.t0 <= float(e["ts"]) <= self.t1

        self.device = sorted([e for e in xs if e.get("cat") in DEVICE_CATS and inside(e)],
                             key=lambda e: e["ts"])
        self.runtime = [e for e in xs if e.get("cat") in RUNTIME_CATS and inside(e)]
        self.spans = sorted([e for e in xs if e.get("cat") == "user_annotation"
                             and e["name"] in SPANS and inside(e)], key=lambda e: e["ts"])
        self.cpu_ops = [e for e in xs if e.get("cat") in ("cpu_op",) + RUNTIME_CATS
                        and inside(e) and e.get("tid") == self.main_tid]

    @classmethod
    def load(cls, path: Path) -> "TraceData":
        with open(path) as f:
            return cls(json.load(f)["traceEvents"])

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def busy_intervals(self) -> list:
        """The union of device activity inside the stretch, as (start, end)."""
        out = []
        for e in self.device:
            a = max(float(e["ts"]), self.t0)
            b = min(float(e["ts"]) + float(e["dur"]), self.t1)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-6

    def in_spans(self, events: list, name: str) -> list:
        """The events that start inside a span `name` of the harness."""
        spans = [(float(s["ts"]), float(s["ts"]) + float(s["dur"]))
                 for s in self.spans if s["name"] == name]
        starts = [a for a, _ in spans]
        out = []
        for e in events:
            t = float(e["ts"])
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and spans[i][0] <= t <= spans[i][1]:
                out.append(e)
        return out

    def launches(self) -> list:
        return [e for e in self.runtime if e["name"].startswith(LAUNCH_PREFIXES)]

    def syncs(self) -> list:
        return [e for e in self.runtime if e["name"] in SYNC_CALLS]

    def host_activity(self, times: list) -> list:
        """What the harness's thread was doing at each of the sorted `times`:
        its span and the innermost operation or runtime call under it (the
        thread's events nest, so one sweep with a stack finds it)."""
        def sweep(events, default):
            events = sorted(events, key=lambda e: float(e["ts"]))
            stack, j, out = [], 0, []
            for t in times:
                while j < len(events) and float(events[j]["ts"]) <= t:
                    e = events[j]
                    while stack and stack[-1][1] < float(e["ts"]):
                        stack.pop()
                    stack.append((e["name"], float(e["ts"]) + float(e["dur"])))
                    j += 1
                while stack and stack[-1][1] < t:
                    stack.pop()
                out.append(stack[-1][0] if stack else default)
            return out

        return [f"{s}: {o}" for s, o in zip(sweep(self.spans, "outside"),
                                             sweep(self.cpu_ops, "python"))]

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle time by
        what the host was doing, in seconds."""
        ops: dict = {}
        for e in self.device:
            name = e["name"][:120]
            ops[name] = ops.get(name, 0.0) + float(e["dur"]) * 1e-6
        idle, prev = [], self.t0
        for a, b in self.busy_intervals() + [[self.t1, self.t1]]:
            if a > prev:
                idle.append((prev, a))
            prev = max(prev, b)
        gaps: dict = {}
        for (a, b), key in zip(idle, self.host_activity([(a + b) / 2 for a, b in idle])):
            gaps[key] = gaps.get(key, 0.0) + (b - a) * 1e-6
        rank = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": rank(ops), "idle_gaps": rank(gaps)}
