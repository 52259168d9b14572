"""The readers of the program's spans on a small hand-written Chrome trace
of two slices, and the rule that the program's spans change no older
reader: `device_idle_pct`, `launches_per_slice`, `host_syncs_per_slice`
and a kernel's roofline read the same with and without them, and the
idle gaps by program span (`program_spans.idle_gaps`), with the span part
of each key taken out, are the breakdown's."""

import itertools
import json
import os
import types

import pytest
import torch

from conftest import ROOT, small_cell
from perfbench import harness, program_spans, spec
from perfbench.tracing import TraceData

MAIN, OTHER = 1, 7
# one slice's program spans, µs from the slice's step_call start
SLICE_SPANS = [
    ("slice", 10, 390), ("dedup", 20, 30), ("fastcluster", 50, 70), ("sae", 130, 10),
    ("candidates", 140, 20), ("efast", 160, 20), ("nms", 190, 60), ("nms.round", 200, 20),
    ("nms.round", 220, 20), ("tracker", 260, 90), ("tracker.associate.round", 270, 20),
    ("tracker.associate.round", 290, 10), ("tracker.group_seeds.round", 310, 20),
]
# per slice, ms: each module's span, the glue (380 µs less 290 under
# modules), and the rounds
EXPECTED = {
    "dedup_span_ms": 0.030, "fastcluster_span_ms": 0.070, "sae_span_ms": 0.010,
    "candidates_span_ms": 0.020, "efast_span_ms": 0.020, "nms_span_ms": 0.060,
    "tracker_span_ms": 0.090, "slice_glue_ms": 0.090, "nms_rounds_per_slice": 2.0,
    "associate_rounds_per_slice": 2.0, "group_seed_rounds_per_slice": 1.0,
}


def _x(name, cat, ts, dur, tid=MAIN):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 1, "tid": tid}


def _events(program: bool) -> list:
    ev = [_x("stretch", "user_annotation", 0, 1000)]
    for t0 in (0, 490):
        ev.append(_x("events_in", "user_annotation", t0 + 2, 6))
        ev.append(_x("step_call", "user_annotation", t0 + 10, 400))
        ev.append(_x("outputs_out", "user_annotation", t0 + 412, 20))
        if program:
            ev += [_x(n, "user_annotation", t0 + 10 + a, d) for n, a, d in SLICE_SPANS]
            # a span on another thread is not the harness's
            ev.append(_x("dedup", "user_annotation", t0 + 30, 300, tid=OTHER))
        ev += [_x("aten::slice", "cpu_op", t0 + 35, 10),
               _x("cudaLaunchKernel", "cuda_runtime", t0 + 65, 3),
               _x("cudaLaunchKernel", "cuda_runtime", t0 + 175, 3),
               _x("cudaStreamSynchronize", "cuda_runtime", t0 + 212, 6),
               _x("cudaStreamSynchronize", "cuda_runtime", t0 + 232, 6),
               _x("cudaStreamSynchronize", "cuda_runtime", t0 + 280, 8),
               _x("aten::copy_", "cpu_op", t0 + 420, 8),
               _x("cudaMemcpyAsync", "cuda_runtime", t0 + 421, 5),
               _x("assign_manhattan_kernel", "kernel", t0 + 70, 30, tid=OTHER),
               _x("elementwise_kernel", "kernel", t0 + 180, 25, tid=OTHER),
               _x("elementwise_kernel", "kernel", t0 + 225, 40, tid=OTHER),
               _x("reduce_kernel", "kernel", t0 + 303, 10, tid=OTHER),
               _x("Memcpy DtoH", "gpu_memcpy", t0 + 422, 5, tid=OTHER)]
    # the profiler's own trailing events past the stretch are not read
    ev.append(_x("slice", "user_annotation", 1200, 50))
    return ev


def _write(path, events):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps({"traceEvents": events}))
    return path


@pytest.fixture
def ctx(tmp_path, monkeypatch):
    """A reader's context over the fixture, read back from a trace file of
    its own, as the harness reads the stretch it wrote."""
    n = itertools.count()

    def make(program: bool, kernel=None, counts=None, events=None):
        d = tmp_path / str(next(n))
        path = _write(d / "trace-cell-1.json", _events(program) if events is None else events)
        monkeypatch.setattr(program_spans, "TRACE_DIR", d)
        return harness.Context(TraceData.load(path), 2, counts or [], {}, kernel)
    return make


def _reader(base):
    return spec.load_module(ROOT / "perfbench" / "metrics" / f"{base}.py")


@pytest.mark.parametrize("base", sorted(EXPECTED))
def test_span_readers_read_the_fixture(ctx, base):
    assert _reader(base).read(ctx(True)) == pytest.approx(EXPECTED[base])
    # the parent's program writes no span: nothing to read
    assert _reader(base).read(ctx(False)) is None


def test_absent_span_reads_nothing(ctx):
    assert _reader("exact_engine_span_ms").read(ctx(True)) is None


def test_a_cpu_trace_reads_nothing(ctx):
    """Without the card's activity the spans are not the card's numbers."""
    c = ctx(True, events=[e for e in _events(True) if e["cat"] not in ("kernel", "gpu_memcpy")])
    assert all(_reader(base).read(c) is None for base in EXPECTED)


def test_spans_come_from_the_stretchs_own_file(tmp_path, monkeypatch):
    """Of the traces under TRACE_DIR, the spans are read from the one whose
    stretch is the trace's, even where another file is newer; a trace whose
    file lies elsewhere reads nothing."""
    mine = _write(tmp_path / "out" / "trace-cell-1.json", _events(True))
    other = _events(True)
    other[0] = _x("stretch", "user_annotation", 0, 999)
    newer = _write(tmp_path / "out" / "trace-cell-2.json", other)
    os.utime(newer, (os.path.getmtime(mine) + 10,) * 2)
    monkeypatch.setattr(program_spans, "TRACE_DIR", tmp_path / "out")
    c = harness.Context(TraceData.load(mine), 2, [], {}, None)
    assert _reader("nms_rounds_per_slice").read(c) == 2.0
    monkeypatch.setattr(program_spans, "TRACE_DIR", tmp_path / "elsewhere")
    c = harness.Context(TraceData.load(mine), 2, [], {}, None)
    assert _reader("nms_rounds_per_slice").read(c) is None


def test_older_readers_read_the_same_with_program_spans(ctx):
    kernel = types.SimpleNamespace(TRACE_NAME="assign_manhattan_kernel",
                                   work=lambda counts, config: (1e6, 0, 0))
    counts = [{"n_events": 1}, {"n_events": 1}]
    for base in ("device_idle_pct", "launches_per_slice", "host_syncs_per_slice"):
        got = [_reader(base).read(ctx(p)) for p in (True, False)]
        assert got[0] == got[1] and got[0] is not None, base
    roof = spec.load_module(ROOT / "perfbench" / "metrics" / "roofline.py")
    got = [roof.read(ctx(p, kernel, counts)) for p in (True, False)]
    assert got[0] == got[1] and got[0] is not None
    assert _reader("launches_per_slice").read(ctx(True)) == 2.0
    assert _reader("host_syncs_per_slice").read(ctx(True)) == 3.0


def test_idle_gaps_name_the_program_span(tmp_path, capsys):
    events = _events(True)
    trace = TraceData(events)
    with_spans = program_spans.idle_gaps(trace, program_spans.select(trace, events), top=100)
    without = TraceData(_events(False)).breakdown(top=100)
    # the breakdown itself does not change with the program's spans
    assert trace.breakdown(top=100) == without
    gaps = dict(with_spans)
    assert "step_call/nms.round: cudaStreamSynchronize" in gaps
    assert "step_call/tracker.associate.round: cudaStreamSynchronize" in gaps
    assert "step_call/dedup: aten::slice" in gaps
    assert "step_call/slice: python" in gaps and "events_in: python" in gaps
    merged = {}
    for key, v in with_spans:
        span, op = key.split(": ", 1)
        k = f"{span.split('/')[0]}: {op}"
        merged[k] = merged.get(k, 0.0) + v
    assert merged == pytest.approx(dict(without["idle_gaps"]))
    # the command prints the same gaps from the file
    assert program_spans.main([str(_write(tmp_path / "t.json", events))]) == 0
    printed = json.loads(capsys.readouterr().out)["idle_gaps"]
    assert dict(printed) == pytest.approx(gaps)


def test_a_real_trace_holds_the_programs_spans(tmp_path, monkeypatch):
    """A traced run at a CPU size: the trace file the harness wrote holds the
    program's `slice` spans inside the stretch on the harness's thread, one
    per slice of the stretch, with the modules' spans inside them."""
    cell = small_cell("q8_textured_live")
    harness.run_cell(cell, 2**31 + 77, 1.0, True, torch.device("cpu"), out_dir=tmp_path,
                     log=lambda *a: None)
    path, = tmp_path.glob("trace-*.json")
    monkeypatch.setattr(program_spans, "TRACE_DIR", tmp_path)
    found = program_spans.spans(TraceData.load(path))
    names = [e["name"] for e in found]
    steps = json.loads(path.read_text())["traceEvents"]
    n_calls = sum(e.get("name") == "step_call" and e.get("ph") == "X" for e in steps)
    assert names.count("slice") == n_calls >= 1
    assert {"dedup", "fastcluster", "sae", "candidates", "efast", "nms", "tracker"} <= set(names)
