"""`dbscan_eps_roofline`'s counts: one launch of csrc/dbscan_eps.cu at
`hd_dbscan_slice` tests every pair of 16384 lanes, 7 fp32 operations
each, and a launch of 200 us reads a share inside (0, 100] % through
metrics/roofline.py."""

import types

import pytest

from conftest import ROOT
from perfbench import harness, peaks, spec


def _load(folder, name):
    return spec.load_module(ROOT / "perfbench" / folder / f"{name}.py")


def _config():
    return spec.read_json(ROOT / "perfbench" / "configs" / "hd_dbscan_slice.json")


def test_work_is_every_pair_of_one_slice():
    kernel = _load("kernels", "dbscan_eps")
    assert kernel.work({}, _config()) == (24 * 16384, 7 * 16384 ** 2, 0)
    assert kernel.work({}, {"slicing": {"n_events": 100}}) == (2400, 70_000, 0)


@pytest.mark.parametrize("launches", [1, 8, 64])
def test_a_launch_of_200_microseconds_reads_under_100(launches):
    """Launch i of the stretch pairs with slice i: every launch's work is
    one slice's pairs, so the share does not depend on launches per slice."""
    kernel = _load("kernels", "dbscan_eps")
    trace = types.SimpleNamespace(device=[
        {"name": f"void (anonymous namespace)::{kernel.TRACE_NAME}<true>(float2 const*, int)",
         "dur": 200.0} for _ in range(launches)] + [{"name": "efast_ring_kernel", "dur": 9.0}])
    ctx = harness.Context(trace, 4, [{}] * 4, _config(), kernel)
    share = _load("metrics", "roofline").read(ctx)
    least = peaks.least_seconds(24 * 16384, 7 * 16384 ** 2)
    assert share == pytest.approx(100 * least / 200e-6)
    assert 0 < share <= 100
    assert 13.5 < share < 14.5       # 1.88 GFLOP at 67 TFLOP/s: 28.0 us of 200


def test_only_the_dbscan_cell_reports_its_roofline():
    names = {m.name for m in spec.load_cell("dbscan_textured_replay").per_layer}
    assert "dbscan_eps_roofline.dbscan" in names
    for cell in ("q8_blobs_replay", "q8_textured_live", "exact_textured_live"):
        assert not any(m.name.startswith("dbscan_eps")
                       for m in spec.load_cell(cell).per_layer), cell
