"""On the card: each cell runs briefly through the harness, correct, with
its metrics. Decides inside the test whether a card exists."""

import json

import pytest
import torch

from conftest import ROOT
from perfbench import harness, spec

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(name, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = spec.load_cell(name)
    r = harness.run_cell(cell, 99, 1.0, False, torch.device("cuda", 0), out_dir=tmp_path)
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {m.name for m in cell.end_to_end}
    assert r["device"]["platform"] == "gpu"
