"""The bound arithmetic equals hand counts (PERF.md's kernel table, slice 3
of the chip_smoke stream: 16384 events, 34 clusters alive, C = 128; the
exact slice's 5609 lanes and 87,499 tests, M = 1024)."""

import pytest

from conftest import ROOT
from perfbench import peaks, spec

CFG = {"cluster": {"max_clusters": 128, "max_members": 1024}}


def _kernel(name):
    return spec.load_module(ROOT / "perfbench" / "kernels" / f"{name}.py")


def test_least_seconds_takes_the_larger_bound():
    assert peaks.least_seconds(3.35e12) == pytest.approx(1.0)
    assert peaks.least_seconds(0, 67e12, 0) == pytest.approx(1.0)
    assert peaks.least_seconds(0, 0, 132 * 64 * 1.98e9) == pytest.approx(1.0)
    assert peaks.least_seconds(3.35e12, 2 * 67e12) == pytest.approx(2.0)


def test_kernel_counts_equal_hand_counts():
    n = {"n_events": 16384, "alive_at_start": 34}
    assert _kernel("assign_manhattan").work(n, CFG) == (263_296, 3_342_336, 0)
    assert _kernel("cluster_stats").work(n, CFG) == (199_168, 327_680, 0)
    ex = {"exact_lanes": 5609, "exact_tests": 87_499}
    assert _kernel("aeclustering_exact").work(ex, CFG) == (116_368, 524_994, 174_998)
    # PERF.md: 0.000079 ms for assign_manhattan, by its bytes
    b, f, i = _kernel("assign_manhattan").work(n, CFG)
    assert peaks.least_seconds(b, f, i) * 1e3 == pytest.approx(0.0000786, rel=1e-3)
