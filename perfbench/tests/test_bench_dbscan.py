"""The cell `dbscan_textured_replay` at a CPU size (2048-event slices at
640x400, 8 objects), through `harness.run_cell`: a sound run is `correct`,
the control (the reference on bfloat16 coordinates) is not, and neither is
a run with a fault planted in `pipeline.dbscan_scan`: half of each slice
left out, one label altered, one centroid moved 2 px. The three readers of
the DBSCAN spans read a small hand-written trace."""

import copy
import json

import pytest
import torch

from conftest import ROOT
from perfbench import harness, program_spans, spec
from perfbench.tracing import TraceData

from evflow_tpu_torch.models import pipeline

CPU = torch.device("cpu")
SEED = 1234567891011


def small_dbscan_cell() -> spec.Cell:
    cell = copy.deepcopy(spec.load_cell("dbscan_textured_replay"))
    cell.config["sensor"] = {"width": 640, "height": 400}
    cell.config["slicing"]["n_events"] = 2048
    tr = cell.traffic
    tr.update(slices=16, slices_per_call=4, scene_params={"num_objects": 8, "noise_frac": 0.5})
    cell.check = {"first": 6, "slices": 4, "chunks": 2}
    return cell


def _run(system="program"):
    return harness.run_cell(small_dbscan_cell(), SEED, 2.0, False, CPU, system=system,
                            log=lambda *a: None)


def _failed(r):
    return [k for k, c in r["checks"].items() if c["value"] > c["limit"]]


def test_sound_run_is_correct():
    r = _run()
    assert r["correct"] is True, r["checks"]
    assert r["metrics"]["events_per_s"]["value"] > 0


def test_control_is_not_correct():
    r = _run("control")
    assert r["correct"] is False
    assert "discrete_mismatches" in _failed(r), r["checks"]


def _half_batch(scan):
    def step(state, x, y, t, valid, cfg):
        v = valid.clone()
        v[:, v.shape[1] // 2:] = False
        return scan(state, x, y, t, v, cfg)
    return step


def _altered(field):
    def wrap(scan):
        def step(*args):
            state, out = scan(*args)
            v = getattr(out, field).clone()
            if field == "labels":
                v[0, int(torch.argmax((v[0] >= 0).to(torch.int32)))] = -1
            else:
                v[0, 0, 0] += 2.0
            return state, out._replace(**{field: v})
        return step
    return wrap


FAULTS = {"half_batch": (_half_batch, "discrete_mismatches"),
          "label_altered": (_altered("labels"), "discrete_mismatches"),
          "centroid_moved": (_altered("centroid"), "float_gap_px")}


@pytest.mark.parametrize("kind", list(FAULTS))
def test_fault_is_not_correct(kind, monkeypatch):
    wrap, number = FAULTS[kind]
    monkeypatch.setattr(pipeline, "dbscan_scan", wrap(pipeline.dbscan_scan))
    r = _run()
    assert r["correct"] is False
    assert number in _failed(r), r["checks"]


def _x(name, cat, ts, dur, tid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 1, "tid": tid}


def _events(dense_slices: int) -> list:
    """Two slices in one call: the grid attempt, then either the dense path
    with three rounds or the table's two rounds."""
    ev = [_x("stretch", "user_annotation", 0, 1000), _x("step_call", "user_annotation", 5, 900)]
    for i, t0 in enumerate((10, 460)):
        ev += [_x("slice", "user_annotation", t0, 400), _x("dbscan", "user_annotation", t0 + 10, 350),
               _x("dbscan.table", "user_annotation", t0 + 20, 40),
               _x("elementwise_kernel", "kernel", t0 + 30, 200, tid=7)]
        if i < dense_slices:
            ev.append(_x("dbscan.dense", "user_annotation", t0 + 70, 280))
            ev += [_x("dbscan.round", "user_annotation", t0 + 100 + 60 * r, 50) for r in range(3)]
        else:
            ev += [_x("dbscan.round", "user_annotation", t0 + 100 + 60 * r, 50) for r in range(2)]
    return ev


@pytest.mark.parametrize("dense_slices", [0, 1, 2])
def test_dbscan_readers_read_a_trace(tmp_path, monkeypatch, dense_slices):
    path = tmp_path / "trace-dbscan_textured_replay-1.json"
    path.write_text(json.dumps({"traceEvents": _events(dense_slices)}))
    monkeypatch.setattr(program_spans, "TRACE_DIR", tmp_path)
    program_spans.spans.cache_clear()
    ctx = harness.Context(TraceData.load(path), 2, [], {})

    def read(base):
        return spec.load_module(ROOT / "perfbench" / "metrics" / f"{base}.py").read(ctx)

    assert read("dbscan_span_ms") == pytest.approx(0.350)
    assert read("dbscan_rounds_per_slice") == pytest.approx((3 * dense_slices
                                                              + 2 * (2 - dense_slices)) / 2)
    assert read("dbscan_dense_per_slice") == pytest.approx(dense_slices / 2)


def test_dbscan_readers_read_nothing_without_the_spans(tmp_path, monkeypatch):
    """The parent's program writes no DBSCAN span: nothing to read."""
    ev = [e for e in _events(2) if not e["name"].startswith("dbscan")]
    path = tmp_path / "trace-dbscan_textured_replay-1.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    monkeypatch.setattr(program_spans, "TRACE_DIR", tmp_path)
    program_spans.spans.cache_clear()
    ctx = harness.Context(TraceData.load(path), 2, [], {})
    for base in ("dbscan_span_ms", "dbscan_rounds_per_slice", "dbscan_dense_per_slice"):
        assert spec.load_module(ROOT / "perfbench" / "metrics" / f"{base}.py").read(ctx) is None
