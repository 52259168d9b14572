"""One run of one cell: set-up, the measured window, the reference's check,
the metrics, and the result line's dict.

`run_cell` takes the device and the system to drive, so that tests run it on
the CPU at small sizes, and the control runs put the reference in the
program's place; `run.py` is the command-line entry, with the guards.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from perfbench import compare, loops, spec
from perfbench.tracing import Tracer

FORBIDDEN = ("jax", "jaxlib", "flax", "evflow_tpu")
WARMUP_CALLS = {"replay": 2, "live": 8}
TRACE_AFTER = 0.3     # the traced stretch starts this share into the window


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, whole, is JAX's or the JAX
    package's (`evflow_tpu_torch` is not `evflow_tpu`)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


@dataclasses.dataclass
class Context:
    """What a per-layer reader reads."""
    trace: object
    stretch_slices: int
    slice_counts: list       # per slice of the stretch the reference covered
    config: dict
    kernel: object = None


def _device_info(device: torch.device, chips: int, peak: int) -> dict:
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": chips, "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "cpu", "count": chips, "memory_peak_bytes": int(peak)}


def check(path, cell, rec: loops.Recording, chunks: list, device: torch.device) -> tuple:
    """Recompute each kept chunk with the reference and compare. Returns
    (numbers, per-slice counts keyed by global slice, slices compared)."""
    path.prepare()
    ref = path.reference(cell.config, device)
    prog_outs, ref_outs, counts_by_slice = [], [], {}
    for c in chunks:
        state = ref.init() if c.snapshot is None else ref.adopt(c.snapshot)
        for k in range(len(c.outs)):
            g = c.start + k
            x, y, t, v = rec.host(g)
            counts: dict = {}
            state, out = ref.step(state, x[None], y[None], t[None], v[None], counts)
            host = ref.host(out)
            ref_outs.append({f: a[0] for f, a in host.items()})
            counts_by_slice[g] = {key: vals[0] for key, vals in counts.items()}
            counts_by_slice[g]["n_events"] = rec.n
        prog_outs.extend(c.outs)
    nums = path.numbers(compare.stack(prog_outs), compare.stack(ref_outs))
    return nums, counts_by_slice, len(prog_outs)


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             device: torch.device, system: str = "program", t_start: Optional[float] = None,
             out_dir: Optional[Path] = None, log=None) -> dict:
    """One run; returns the result line's dict. `system`: "program" or
    "control" (the reference in the program's place, in the precision
    below the configuration's)."""
    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    t_start = time.perf_counter() if t_start is None else t_start
    tr = cell.traffic
    loop = tr["loop"]
    spc = tr["slices_per_call"]
    path = cell.path_module()
    rec = loops.Recording(cell, seed, device)
    if system == "program":
        sut = path.program(cell.config, device)
    else:
        path.prepare()
        sut = path.reference(cell.config, device, control=True)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    loops.run_calls(sut, sut.init(), rec, spc, WARMUP_CALLS[loop], device)
    state = sut.init()
    checker = loops.Checker(cell.check, spc, seed)
    tracer = None
    if trace:
        out = (out_dir or spec.ROOT / "perfbench_out") / f"trace-{cell.name}-{seed}.json"
        tracer = Tracer(out, TRACE_AFTER * seconds, device)
    loops.sync(device)
    setup_s = time.perf_counter() - t_start
    if loop == "replay":
        win = loops.replay(sut, state, rec, seconds, spc, checker, tracer, device)
    else:
        win = loops.live(sut, state, rec, seconds, tr["rate_events_per_s"], checker,
                         tracer, device)
    loops.sync(device)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    chunks = checker.chunks()
    del state, win.end_state, sut
    if device.type == "cuda":
        torch.cuda.empty_cache()

    late = loops.schedule_lateness(win)
    if late:
        log("schedule: started late by (ms) " + " ".join(f"{k} {v:.3f}" for k, v in late.items()))
        thirds = np.array_split(np.asarray(win.latencies_s) * 1e3, 3)
        log("latency p50 by third of the window (ms): "
            + " ".join(f"{float(np.median(t)):.3f}" for t in thirds if len(t)))
    t_check = time.perf_counter()
    nums, counts, n_compared = check(path, cell, rec, chunks, device)
    log(f"check: {n_compared} slices in {len(chunks)} chunks recomputed by the reference "
        f"in {time.perf_counter() - t_check:.1f} s")
    work = {k: float(np.mean([c[k] for c in counts.values()]))
            for k in sorted(next(iter(counts.values())))} if counts else {}
    log("work per slice (reference, compared slices): "
        + " ".join(f"{k} {v:.1f}" for k, v in work.items()))

    checks = {k: {"value": v, "limit": cell.limits[k]} for k, v in nums.items()}
    correct = all(v <= cell.limits[k] for k, v in nums.items())
    result = {"correct": correct, "attempted": win.attempted, "failed": win.failed}
    device_info = _device_info(device, cell.chips, peak)
    if not trace:
        measured = loops.end_to_end(win, rec.n)
        measured["setup_s"] = setup_s
        metrics = {}
        for m in cell.end_to_end:
            if m.name not in measured:
                raise KeyError(f"the {loop} loop gives no {m.name}")
            metrics[m.name] = {"value": measured[m.name], "unit": m.unit}
        result["metrics"] = metrics
    else:
        data = tracer.data if tracer else None
        metrics = {}
        if data is not None:
            traced = [c for c in chunks if c.traced]
            slice_counts = ([counts[traced[0].start + k] for k in range(len(traced[0].outs))]
                            if traced else [])
            for m in cell.per_layer:
                reader, kernel = cell.metric_reader(m)
                ctx = Context(data, tracer.slices, slice_counts, cell.config, kernel)
                v = reader.read(ctx)
                if v is not None:
                    metrics[m.name] = {"value": v, "unit": m.unit}
            device_info["busy_s"] = data.busy_s()
            device_info["window_s"] = data.window_s
            result["breakdown"] = data.breakdown()
        result["metrics"] = metrics
    result["device"] = device_info
    for k, c in checks.items():
        log(f"check {k}: {c['value']} limit {c['limit']}")
    result["checks"] = checks
    return result
