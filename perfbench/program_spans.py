"""What the per-layer readers read from the program's own spans in a traced
stretch: the spans that `evflow_tpu_torch/utils/profiling.py` writes around
each slice (`slice`), each module's call and each round of a host-checked
fixpoint, nested inside the harness's `step_call`. The stretch's slices are
its `slice` spans. A span's duration is the host's time inside it: its
module's launches and Python, and any wait on the card inside it, such as a
round's sync. Each reader gives None where the trace holds no span of its
name, as a program without the spans, or a path that runs no such module,
gives, and where it holds no activity of the card: a CPU run's spans are not
the card's numbers.

`TraceData` keeps only the harness's spans, so the program's are read from
the Chrome trace file the stretch was written to: the newest file under
`TRACE_DIR` whose `stretch` span is the trace's own.

As a command, it prints a trace file's idle gaps by where the host was, the
innermost program span named between the harness's span and the operation
(`step_call/efast: aten::slice`), beside the breakdown's own keys:

    python3 -m perfbench.program_spans perfbench_out/trace-<cell>-<seed>.json
"""

from __future__ import annotations

import functools
import json
import sys

from perfbench import spec
from perfbench.tracing import SPANS, TraceData

TRACE_DIR = spec.ROOT / "perfbench_out"   # where `run.py` has the harness write its traces


def _stretch(events: list):
    return next((e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                 and e.get("name") == "stretch"), None)


def select(trace, events: list) -> list:
    """The program's spans among `events`: user annotations inside `trace`'s
    stretch on the harness's thread other than the harness's own, each parent
    before a child that starts with it."""
    return sorted([e for e in events if e.get("ph") == "X" and "dur" in e
                   and e.get("cat") == "user_annotation"
                   and e["name"] not in SPANS + ("stretch",)
                   and trace.t0 <= float(e["ts"]) <= trace.t1
                   and e.get("tid") == trace.main_tid],
                  key=lambda e: (float(e["ts"]), -float(e["dur"])))


def _file_events(trace) -> list:
    """The events of the trace file `trace` was read from, or none."""
    paths = sorted(TRACE_DIR.glob("trace-*.json"), key=lambda p: p.stat().st_mtime,
                   reverse=True) if TRACE_DIR.is_dir() else []
    for path in paths:
        try:
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        except (OSError, ValueError, KeyError):
            continue
        s = _stretch(events)
        if (s is not None and float(s["ts"]) == trace.t0
                and float(s["ts"]) + float(s["dur"]) == trace.t1
                and s.get("tid") == trace.main_tid):
            return events
    return []


@functools.lru_cache(maxsize=1)
def spans(trace) -> list:
    """The program's spans in `trace`'s stretch (read once per trace)."""
    return select(trace, _file_events(trace))


def _slices(trace) -> list:
    if not trace.device:
        return []
    return [e for e in spans(trace) if e["name"] == "slice"]


def _intervals(events) -> list:
    return sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events)


def _union(intervals: list) -> list:
    """The union of sorted intervals as disjoint ones: spans nest, so these
    are the outermost spans, and a span nested in one of its own name
    counts once."""
    out = []
    for a, b in intervals:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def ms_per_slice(trace, name: str):
    """The summed duration of the outermost spans named `name`, per slice,
    in ms."""
    slices = _slices(trace)
    named = [e for e in spans(trace) if e["name"] == name] if slices else []
    if not named:
        return None
    return sum(b - a for a, b in _union(_intervals(named))) * 1e-3 / len(slices)


def count_per_slice(trace, name: str):
    """The spans named `name` per slice: a fixpoint's rounds."""
    slices = _slices(trace)
    n = sum(e["name"] == name for e in spans(trace)) if slices else 0
    if not n:
        return None
    return n / len(slices)


def slice_self_ms(trace):
    """The `slice` spans' self time per slice, in ms: each slice's duration
    less the part of it that the program's other spans cover, the per-slice
    glue of no module."""
    slices = _intervals(_slices(trace))
    if not slices:
        return None
    children = _union(_intervals([e for e in spans(trace) if e["name"] != "slice"]))
    total = 0.0
    for a, b in slices:
        covered = sum(max(0.0, min(b, d) - max(a, c)) for c, d in children)
        total += (b - a) - covered
    return total * 1e-3 / len(slices)


def innermost(events: list, times: list) -> list:
    """The innermost of the nested `events` open at each of the sorted
    `times`, by name, or "" (one sweep with a stack)."""
    events = sorted(events, key=lambda e: (float(e["ts"]), -float(e["dur"])))
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
        out.append(stack[-1][0] if stack else "")
    return out


def idle_gaps(trace, program: list, top: int = 10) -> list:
    """The breakdown's idle gaps, in seconds, with the innermost program span
    the host was in named after the harness's span: `step_call/efast:
    aten::slice`. Merged over program spans, they are the breakdown's."""
    idle, prev = [], trace.t0
    for a, b in trace.busy_intervals() + [[trace.t1, trace.t1]]:
        if a > prev:
            idle.append((prev, a))
        prev = max(prev, b)
    mids = [(a + b) / 2 for a, b in idle]
    gaps: dict = {}
    for (a, b), key, p in zip(idle, trace.host_activity(mids), innermost(program, mids)):
        span, op = key.split(": ", 1)
        k = f"{span}/{p}: {op}" if p else key
        gaps[k] = gaps.get(k, 0.0) + (b - a) * 1e-6
    return [[k, v] for k, v in sorted(gaps.items(), key=lambda kv: -kv[1])[:top]]


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if len(args) != 1:
        print(__doc__.strip().splitlines()[-1].strip(), file=sys.stderr)
        return 2
    with open(args[0]) as f:
        events = json.load(f)["traceEvents"]
    trace = TraceData(events)
    print(json.dumps({"idle_gaps": idle_gaps(trace, select(trace, events), top=20)}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
