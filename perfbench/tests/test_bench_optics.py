"""The cell `optics_textured_replay` at a CPU size (2048-event slices of the
1280x720 sensor, 4 objects: the dense table, as at full size), through
`harness.run_cell`: a sound run is `correct`, the control (the reference on
bfloat16 coordinates) is not, and neither is a run with a fault planted in
`pipeline.optics_scan`: a slice left out, a table truncated to K = 8 (its
counts cut to match, so nothing refuses it), one size altered (+1), one
centroid moved 2 px. The readers of the OPTICS spans read a small
hand-written trace, and nothing where the spans are missing."""

import copy
import json

import pytest
import torch

from conftest import ROOT
from perfbench import harness, program_spans, spec
from perfbench.tracing import TraceData

from evflow_tpu_torch.models import optics, pipeline

CPU = torch.device("cpu")
SEED = 2345678910111
READERS = ("optics_span_ms", "optics_table_ms", "optics_sweep_ms")


@pytest.fixture(scope="module", autouse=True)
def accurate_sqrt():
    """The CPU build's first large float32 sqrt in a process can run some of
    its threads at reduced accuracy (about 2^-12 relative); one large sqrt
    first keeps every compared run on the accurate path."""
    torch.sqrt(torch.rand(2048, 16384))


def small_optics_cell() -> spec.Cell:
    cell = copy.deepcopy(spec.load_cell("optics_textured_replay"))
    cell.config["slicing"]["n_events"] = 2048
    tr = cell.traffic
    tr.update(slices=16, slices_per_call=4, scene_params={"num_objects": 4, "noise_frac": 0.5})
    cell.check = {"first": 6, "slices": 4, "chunks": 2}
    return cell


def _run(system="program"):
    return harness.run_cell(small_optics_cell(), SEED, 1.0, False, CPU, system=system,
                            log=lambda *a: None)


def _failed(r):
    return [k for k, c in r["checks"].items() if c["value"] > c["limit"]]


def test_sound_run_is_correct():
    r = _run()
    assert r["correct"] is True, r["checks"]
    assert r["checks"]["float_gap_px"]["value"] < 1e-3
    assert r["metrics"]["events_per_s"]["value"] > 0


def test_control_is_not_correct():
    r = _run("control")
    assert r["correct"] is False
    assert "discrete_mismatches" in _failed(r), r["checks"]


def _slice_left_out(scan):
    def step(state, x, y, t, valid, cfg, threshold):
        v = valid.clone()
        v[0] = False
        return scan(state, x, y, t, v, cfg, threshold)
    return step


def _altered(field):
    def wrap(scan):
        def step(*args):
            state, out = scan(*args)
            v = getattr(out, field).clone()
            if field == "size":
                v[0, 0] += 1
            else:
                v[0, 0, 0] += 2.0
            return state, out._replace(**{field: v})
        return step
    return wrap


def _truncated(monkeypatch):
    build = optics.build_table

    def narrow(*a, **kw):
        t = build(*a, **kw)
        return optics.NeighborTable(t.idx[:, :8], t.dist[:, :8], t.count.clamp_max(8),
                                    t.core_dist)

    monkeypatch.setattr(optics, "build_table", narrow)


FAULTS = {"slice_left_out": "discrete_mismatches", "table_truncated": "discrete_mismatches",
          "size_altered": "discrete_mismatches", "centroid_moved": "float_gap_px"}


@pytest.mark.parametrize("kind", list(FAULTS))
def test_fault_is_not_correct(kind, monkeypatch):
    if kind == "table_truncated":
        _truncated(monkeypatch)
    else:
        wrap = {"slice_left_out": _slice_left_out, "size_altered": _altered("size"),
                "centroid_moved": _altered("centroid")}[kind]
        monkeypatch.setattr(pipeline, "optics_scan", wrap(pipeline.optics_scan))
    r = _run()
    assert r["correct"] is False
    assert FAULTS[kind] in _failed(r), r["checks"]


def _x(name, cat, ts, dur, tid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 1, "tid": tid}


def _events() -> list:
    """Two slices in one call, each with its table, sweep and extraction."""
    ev = [_x("stretch", "user_annotation", 0, 1000), _x("step_call", "user_annotation", 5, 900)]
    for t0 in (10, 460):
        ev += [_x("slice", "user_annotation", t0, 400), _x("optics", "user_annotation", t0 + 10, 360),
               _x("optics.table", "user_annotation", t0 + 20, 60),
               _x("elementwise_kernel", "kernel", t0 + 30, 40, tid=7),
               _x("optics.sweep", "user_annotation", t0 + 90, 250),
               _x("optics.extract", "user_annotation", t0 + 345, 20)]
    return ev


def _context(tmp_path, monkeypatch, events):
    path = tmp_path / "trace-optics_textured_replay-1.json"
    path.write_text(json.dumps({"traceEvents": events}))
    monkeypatch.setattr(program_spans, "TRACE_DIR", tmp_path)
    program_spans.spans.cache_clear()
    return harness.Context(TraceData.load(path), 2, [], {})


def _read(base, ctx):
    return spec.load_module(ROOT / "perfbench" / "metrics" / f"{base}.py").read(ctx)


def test_optics_readers_read_a_trace(tmp_path, monkeypatch):
    ctx = _context(tmp_path, monkeypatch, _events())
    assert _read("optics_span_ms", ctx) == pytest.approx(0.360)
    assert _read("optics_table_ms", ctx) == pytest.approx(0.060)
    assert _read("optics_sweep_ms", ctx) == pytest.approx(0.250)
    assert _read("slice_glue_ms", ctx) == pytest.approx(0.040)


def test_optics_readers_read_nothing_without_the_spans(tmp_path, monkeypatch):
    """The parent's program writes no OPTICS span: nothing to read."""
    ev = [e for e in _events() if not e["name"].startswith("optics")]
    ctx = _context(tmp_path, monkeypatch, ev)
    for base in READERS:
        assert _read(base, ctx) is None


def test_the_cell_reports_its_metrics():
    """Every metric the cell names resolves to a reader file."""
    cell = spec.load_cell("optics_textured_replay")
    names = {m.name for m in cell.per_layer}
    assert {f"{b}.optics" for b in READERS + ("device_idle_pct", "launches_per_slice",
                                              "host_syncs_per_slice", "slice_glue_ms")} == names
    for m in cell.per_layer:
        reader, kernel = cell.metric_reader(m)
        assert hasattr(reader, "read") and kernel is None
    assert [m.name for m in cell.end_to_end] == ["events_per_s", "setup_s"]
