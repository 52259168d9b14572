"""A whole run at a CPU size: the result line has exactly the contract's
keys, and the guards hold."""

import json
import shutil
import subprocess
import sys

import torch

from conftest import ROOT, small_cell
from perfbench import harness

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def test_result_line_keys(tmp_path):
    cell = small_cell("q8_blobs_replay")
    r = harness.run_cell(cell, 2**31 + 5, 1.0, False, torch.device("cpu"),
                         log=lambda *a: None)
    assert list(r) == KEYS
    assert set(r["metrics"]) == {"events_per_s", "setup_s"}
    assert set(r["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert r["correct"] is True and r["failed"] == 0
    assert all(set(c) == {"value", "limit"} for c in r["checks"].values())
    json.dumps(r)

    t = harness.run_cell(small_cell("q8_textured_live"), 77, 1.0, True, torch.device("cpu"),
                         out_dir=tmp_path, log=lambda *a: None)
    assert sorted(t) == sorted(KEYS + ["breakdown"]) and list(t)[-1] == "checks"
    assert {"busy_s", "window_s"} <= set(t["device"])
    assert set(t["breakdown"]) == {"device_ops", "idle_gaps"}
    # no device, so nothing to read: every per-layer reader stays silent
    assert t["metrics"] == {}


def test_no_card_no_result():
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "q8_blobs_replay",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_without_the_program_a_run_fails(tmp_path):
    """A checkout holding only BENCHMARK.json and perfbench/ has no program."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys, torch; sys.path.insert(0, 'perfbench/tests');"
            "from conftest import small_cell; from perfbench import harness;"
            "harness.run_cell(small_cell('q8_blobs_replay'), 1, 0.5, False, torch.device('cpu'))")
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode != 0 and "evflow_tpu_torch" in p.stderr
