"""The port's grid-bucketed eps-neighborhoods (`models/optics.py`,
`compute_neighbors_grid`) against the JAX package's, on the cases of
tests/test_optics.py: integer and float 2-D points, 3-D, the opt-in
projected grid at d = 5 and 6, the exact 4-D grid, full_window with its
entry cap, sorted selection, and every case that returns None.

Tolerances: idx and count equal; dist and core_dist within rtol 1e-6
(JAX's sqrt on the CPU is sometimes one ulp off a correctly rounded one),
inf exactly where JAX has inf. On float data a pair within an ulp of eps
could round either way; each float case asserts that no pair lies within
1e-5 * eps of eps (160 float32 ulps), so the neighbor sets are equal."""

import numpy as np
import pytest
import torch

from evflow_tpu.io.synthetic import uniform_cloud
from evflow_tpu.models import optics as joptics
from evflow_tpu_torch.models import optics

torch.set_num_threads(2)


def _clear_of_eps(pts, eps):
    d = np.sqrt(((pts[:, None, :].astype(np.float64) - pts[None, :, :]) ** 2).sum(-1))
    assert np.abs(d - eps).min() > 1e-5 * eps


def _assert_tables_equal(got, want):
    assert (got is None) == (want is None)
    if want is None:
        return
    for name in ("idx", "count"):
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    for name in ("dist", "core_dist"):
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(np.isinf(g), np.isinf(w), err_msg=name)
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=0, err_msg=name)


def _both(pts, eps, min_pts, **kw):
    got = optics.compute_neighbors_grid(pts, eps, min_pts, device="cpu", **kw)
    want = joptics.compute_neighbors_grid(pts, eps, min_pts, **kw)
    _assert_tables_equal(got, want)
    return got


# seeds whose uniform clouds keep every pair clear of eps (see above)
SEEDS = {1: 2, 2: 3, 3: 2, 4: 2, 5: 3, 6: 2}


def _float_case(dim, n=1000, min_pts=10):
    pts = uniform_cloud(n, dim, 1000.0, seed=SEEDS[dim])
    eps = joptics.epsilon_estimation(pts, min_pts)
    _clear_of_eps(pts, eps)
    return pts, eps


def test_integer_coords():
    """Integer coordinates: every term exact."""
    pts = np.random.default_rng(7).integers(0, 200, (1500, 2)).astype(np.float64)
    g = _both(pts, 7.0, 6)
    assert g is not None and int(g.count.max()) > 6


def test_float_2d_and_3d():
    rng = np.random.default_rng(11)
    pts = rng.uniform(0, 100, (1200, 2))
    eps = joptics.epsilon_estimation(pts, 8)
    _clear_of_eps(pts, eps)
    assert _both(pts, eps, 8) is not None
    pts3 = np.random.default_rng(13).uniform(0, 50, (600, 3))
    eps3 = joptics.epsilon_estimation(pts3, 4)
    _clear_of_eps(pts3, eps3)
    assert _both(pts3, eps3, 4) is not None


@pytest.mark.parametrize("dim", [1, 2, 3])
def test_select_k(dim):
    """max_neighbors 16 below the window: the nearest, sorted stably."""
    pts, eps = _float_case(dim)
    g = _both(pts, eps, 10, max_neighbors=16)
    assert g is not None and g.idx.shape[1] == 16


def test_none_cases():
    """d > 4 without allow_projected, an over-full cell (bucket above
    max_bucket), a degenerate grid, no points, and min_pts above
    max_neighbors where selection is needed."""
    rng = np.random.default_rng(13)
    pts6 = rng.uniform(0, 10, (100, 6))
    dense = np.concatenate([np.zeros((300, 2)), rng.uniform(0, 9, (9, 2))])
    wide = rng.uniform(0, 1, (50, 2))
    cases = [(pts6, 2.0, 3, {}), (dense, 3.0, 3, dict(max_bucket=128)),
             (wide, 1e-5, 3, {}), (np.zeros((0, 2)), 1.0, 3, {}),
             (rng.uniform(0, 10, (400, 2)), 2.0, 40, dict(max_neighbors=16))]
    for pts, eps, min_pts, kw in cases:
        assert optics.compute_neighbors_grid(pts, eps, min_pts, device="cpu", **kw) is None
        assert joptics.compute_neighbors_grid(pts, eps, min_pts, **kw) is None


@pytest.mark.parametrize("dim,proj", [(5, 3), (6, 3), (6, 4)])
def test_projected(dim, proj):
    pts, eps = _float_case(dim, n=800)
    assert _both(pts, eps, 10, max_neighbors=512, allow_projected=True,
                 proj_dims=proj) is not None


@pytest.mark.parametrize("dim", [2, 3, 4])
def test_full_window(dim):
    """full_window ignores max_neighbors: the whole masked window, unsorted,
    core distances by top-k."""
    pts, eps = _float_case(dim)
    g = _both(pts, eps, 10, max_neighbors=16, full_window=True)
    assert g is not None and g.idx.shape[1] == 3 ** dim * (g.idx.shape[1] // 3 ** dim)


def test_4d_select_and_entry_cap():
    """The 4-D grid's sorted selection, and full_window over its entry cap
    falling back to selection (at d = 4 and d = 3)."""
    pts4, eps = _float_case(4)
    g = _both(pts4, eps, 10, max_neighbors=64)
    assert g is not None and g.idx.shape[1] <= 81 * 64
    g = _both(pts4, eps, 10, max_neighbors=16, full_window=True, full_window_entry_cap=1000)
    assert g is not None and g.idx.shape[1] == 16
    pts3, eps3 = _float_case(3)
    g3 = _both(pts3, eps3, 10, max_neighbors=16, full_window=True, full_window_entry_cap=1000)
    assert g3 is not None and g3.idx.shape[1] == 16

