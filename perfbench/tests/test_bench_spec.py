"""Every piece BENCHMARK.json names resolves by name, the file keeps the
contract's shape, and a cell made only of new files is picked up."""

import json
import shutil

import pytest

from conftest import ROOT
from perfbench import spec

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_benchmark_file_has_the_contract_keys():
    assert set(BENCH) == TOP_KEYS
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    names = [e["name"] for e in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names)) and "setup_s" in names
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves_by_name(name):
    cell = spec.load_cell(name)
    path = cell.path_module()
    assert callable(path.program) and callable(path.reference)
    assert callable(cell.scene_module().generate)
    assert {"discrete_mismatches", "float_gap_px"} <= set(cell.limits)
    assert {m.name for m in cell.end_to_end} >= {"setup_s"}
    assert cell.per_layer, "every cell reports a per-layer metric"
    for m in cell.per_layer:
        reader, kernel = cell.metric_reader(m)
        assert callable(reader.read)
        if m.base.endswith(spec.ROOFLINE_SUFFIX):
            assert kernel.TRACE_NAME and callable(kernel.work)


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_is_its_own(conf):
    cfg = json.loads((ROOT / conf["file"]).read_text())
    assert cfg["name"] == conf["name"] and cfg["reduced"] == conf["reduced"] == []
    assert (ROOT / "perfbench" / "paths" / f"{cfg['path']}.py").exists()
    assert (ROOT / "perfbench" / "limits" / f"{conf['name']}.json").exists()


def test_a_cell_of_new_files_is_picked_up(tmp_path):
    """A later change adds a traffic mix, a scene, a metric and a kernel's
    roofline as new files and new entries only."""
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    pb = tmp_path / "perfbench"
    (pb / "scenes" / "still.py").write_text(
        "import numpy as np\n"
        "def generate(rng, num_slices, events_per_slice, slice_us, width, height):\n"
        "    x = rng.integers(0, width, (num_slices, events_per_slice)).astype(np.int32)\n"
        "    y = rng.integers(0, height, (num_slices, events_per_slice)).astype(np.int32)\n"
        "    t = np.sort(rng.integers(0, slice_us, (num_slices, events_per_slice)), 1)\n"
        "    return x, y, t + np.arange(num_slices)[:, None] * slice_us\n")
    (pb / "traffic" / "still_replay.json").write_text(json.dumps(
        {"scene": "still", "loop": "replay", "slices": 64, "slices_per_call": 32,
         "slice_us": 50000}))
    (pb / "metrics" / "idle_gap_count.py").write_text(
        "def read(ctx):\n    return None\n")
    (pb / "kernels" / "efast_stencil.py").write_text(
        "TRACE_NAME = 'efast_stencil_kernel'\n"
        "def work(counts, config):\n    return counts['n_events'] * 4, 0, 0\n")
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "q8_still_replay", "config": "hd_track_q8",
                               "traffic": "still_replay", "chips": 1, "why": "new"})
    bench["end_to_end"][0].setdefault("workloads", []).append("q8_still_replay")
    bench["per_layer"] += [
        {"name": "idle_gap_count.replay", "unit": "gaps", "better": "lower",
         "source": "device_trace", "layer": "device (H100)", "moves": "events_per_s",
         "workloads": ["q8_still_replay"]},
        {"name": "efast_stencil_roofline.replay", "unit": "%", "better": "higher",
         "source": "device_trace", "layer": "kernels (csrc/)", "moves": "events_per_s",
         "workloads": ["q8_still_replay"]}]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load_cell("q8_still_replay", root=tmp_path)
    assert cell.traffic["scene"] == "still"
    names = {m.name for m in cell.per_layer}
    assert {"idle_gap_count.replay", "efast_stencil_roofline.replay"} <= names
    for m in cell.per_layer:
        reader, kernel = cell.metric_reader(m)
        if m.name.startswith("efast_stencil"):
            assert kernel.TRACE_NAME == "efast_stencil_kernel"
    import numpy as np
    x, y, t = cell.scene_module().generate(np.random.default_rng(0), 2, 8, 100, 32, 16)
    assert x.shape == (2, 8) and t.max() < 200
