"""`rep_candidates_roofline`'s counts: one launch of csrc/rep_candidates.cu
at `hd_track_q8` is one slice's 8 rows of 2,048 lanes into 1,024 slots,
221,216 bytes and no counted operations, and a launch of 5 us reads a
share inside (0, 100] % through metrics/roofline.py."""

import re
import types

import pytest

from conftest import ROOT
from perfbench import harness, peaks, spec


def _load(folder, name):
    return spec.load_module(ROOT / "perfbench" / folder / f"{name}.py")


def _config():
    return spec.read_json(ROOT / "perfbench" / "configs" / "hd_track_q8.json")


def test_work_is_one_slice_of_rows():
    kernel = _load("kernels", "rep_candidates")
    assert kernel.work({}, _config()) == (221_216, 0, 0)
    assert kernel.work({}, _config()) == (8 * (2048 * 9 + 1024 * 9 + 4), 0, 0)
    small = {"slicing": {"n_events": 1024},
             "efast": {"max_candidates": 256, "micro_slices": 8}}
    assert kernel.work({}, small) == (8 * (128 * 9 + 64 * 9 + 4), 0, 0)   # the floor of 64


def test_trace_name_is_the_kernels_symbol():
    """The roofline finds the launches by this name in the device trace,
    where the symbol is the __global__ function's."""
    kernel = _load("kernels", "rep_candidates")
    src = (ROOT / "evflow_tpu_torch" / "csrc" / "rep_candidates.cu").read_text()
    names = re.findall(r"__global__ void __launch_bounds__\([^)]*\)\s*(\w+)\(", src)
    assert names == [kernel.TRACE_NAME]


@pytest.mark.parametrize("launches", [1, 8, 64])
def test_a_launch_of_five_microseconds_reads_under_100(launches):
    """Launch i of the stretch pairs with slice i: one launch is a slice."""
    kernel = _load("kernels", "rep_candidates")
    trace = types.SimpleNamespace(device=[
        {"name": f"void (anonymous namespace)::{kernel.TRACE_NAME}<false>(int const*, int)",
         "dur": 5.0} for _ in range(launches)] + [{"name": "efast_ring_kernel", "dur": 9.0}])
    ctx = harness.Context(trace, 4, [{}] * 4, _config(), kernel)
    share = _load("metrics", "roofline").read(ctx)
    least = peaks.least_seconds(221_216)
    assert share == pytest.approx(100 * least / 5e-6)
    assert 0 < share < 100
    assert 1.2 < share < 1.4          # 221,216 bytes at 3.35 TB/s: 0.066 us of 5


def test_the_q8_cells_report_its_roofline():
    for cell, suffix in (("q8_blobs_replay", "replay"), ("q8_textured_live", "live")):
        names = {m.name for m in spec.load_cell(cell).per_layer}
        assert f"rep_candidates_roofline.{suffix}" in names, cell
    for cell in ("exact_textured_live", "dbscan_textured_replay"):
        assert not any(m.name.startswith("rep_candidates")
                       for m in spec.load_cell(cell).per_layer), cell
