"""`correct` comes out false for the control and for each fault a cell can
have (`perfbench/faults.py`), planted in the timed path underneath a whole
run (CPU size, the harness's look for a card skipped); a sound run comes out
true."""

import pytest
import torch

from conftest import small_cell
from perfbench import faults, harness

from evflow_tpu_torch.models import pipeline

CPU = torch.device("cpu")
# each configuration under the blobs replay, with window seconds long enough
# for two calls, so the first chunk crosses a call's end
CELLS = {"q8_blobs_replay": 3.0, "exact_textured_live": 5.0}


def _run(name, system="program"):
    return harness.run_cell(small_cell(name, "blobs_replay"), 1234567891011, CELLS[name],
                            False, CPU, system=system, log=lambda *a: None)


@pytest.mark.parametrize("name", list(CELLS))
def test_sound_run_is_correct(name):
    assert _run(name)["correct"] is True


@pytest.mark.parametrize("name", list(CELLS))
def test_control_is_not_correct(name):
    r = _run(name, system="control")
    assert r["correct"] is False
    failed = [k for k, c in r["checks"].items() if c["value"] > c["limit"]]
    assert failed, r["checks"]


@pytest.mark.parametrize("kind", faults.KINDS)
@pytest.mark.parametrize("name", list(CELLS))
def test_fault_is_not_correct(name, kind, monkeypatch):
    path = small_cell(name, "blobs_replay").config["path"]
    entry = faults.ENTRIES[path][0]
    monkeypatch.setattr(pipeline, entry, faults.broken(kind, path, getattr(pipeline, entry)))
    r = _run(name)
    assert r["correct"] is False, r["checks"]
