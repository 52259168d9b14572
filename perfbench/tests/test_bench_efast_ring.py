"""`efast_ring_roofline`'s counts: one launch of csrc/efast_ring.cu at
`hd_track_q8` is one sub-slice of 1,024 lanes of 154 bytes, and a launch
of 2 us reads a share inside (0, 100] % through metrics/roofline.py."""

import types

import pytest

from conftest import ROOT
from perfbench import harness, peaks, spec


def _load(folder, name):
    return spec.load_module(ROOT / "perfbench" / folder / f"{name}.py")


def _config():
    return spec.read_json(ROOT / "perfbench" / "configs" / "hd_track_q8.json")


def test_work_is_one_sub_slice_of_lanes():
    kernel = _load("kernels", "efast_ring")
    assert kernel.work({}, _config()) == (1024 * 154, 0, 0)
    small = {"efast": {"max_candidates": 256, "micro_slices": 8}}
    assert kernel.work({}, small) == (64 * 154, 0, 0)     # the floor of 64 lanes


@pytest.mark.parametrize("launches", [1, 8, 64])
def test_a_launch_of_two_microseconds_reads_under_100(launches):
    """Launch i of the stretch pairs with slice i: every launch's work is
    one sub-slice, so eight launches per slice read as one."""
    kernel = _load("kernels", "efast_ring")
    trace = types.SimpleNamespace(device=[
        {"name": f"void (anonymous namespace)::{kernel.TRACE_NAME}<true, 3, 6, 4, 8>(int)",
         "dur": 2.0} for _ in range(launches)] + [{"name": "efast_stencil_kernel", "dur": 9.0}])
    ctx = harness.Context(trace, 4, [{}] * 4, _config(), kernel)
    share = _load("metrics", "roofline").read(ctx)
    least = peaks.least_seconds(1024 * 154)
    assert share == pytest.approx(100 * least / 2e-6)
    assert 0 < share < 100
    assert 2.0 < share < 2.5          # 157,696 bytes at 3.35 TB/s: 0.047 us of 2


def test_cells_that_run_the_ring_test_report_its_roofline():
    for cell in ("q8_blobs_replay", "q8_textured_live"):
        names = {m.name for m in spec.load_cell(cell).per_layer}
        assert {n for n in names if n.startswith("efast_ring_roofline")}, cell
    assert not any(m.name.startswith("efast_ring")
                   for m in spec.load_cell("exact_textured_live").per_layer)
