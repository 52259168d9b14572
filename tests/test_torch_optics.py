"""The port's OPTICS (`evflow_tpu_torch.models.optics`) against the JAX
package's, test for test after tests/test_optics.py: the reference's
vectors, chi 1-11, the cluster tree, export, every neighbor backend, the
neighbor cap with its auto-raise warnings, the declines, and eps at high d.
Each test gives both packages the same seeded numpy input; the port runs on
device="cpu". Some clouds are smaller than the JAX tests' to keep the
suite's time.

Tolerances:
- integer coordinates: every distance term is exact in fp32, so the
  tables are bit-equal; reachability: the same visit order, reach within
  rtol 1e-6. On the cap test's 1/8 grid, idx and count are equal and dist
  and core_dist within rtol 1e-6 (JAX's sqrt on the CPU is sometimes one
  ulp off a correctly rounded one);
- float data, grid and cell-pair tables: idx and count equal, dist and
  core_dist within rtol 1e-6; every such cloud keeps its pairs more than
  1e-5 * eps away from eps, so no pair can round across it;
- float data, dense tables: JAX's panel takes its cross term from a matmul
  and the port sums differences squared, so distances agree within the JAX
  tests' own rtol 1e-3, atol 0.02, and the neighbor sets are equal once
  pairs within that bound of eps are left out;
- float clouds, reachability: the JAX tests' own criteria: the same
  unreached points, at least 0.995 of reaches within rtol 1e-3, atol 0.05,
  and the same clusters.
"""

import os
import warnings

import numpy as np
import pytest
import torch

from evflow_tpu import native as jnative
from evflow_tpu.io.synthetic import uniform_cloud
from evflow_tpu.models import optics as J
from evflow_tpu_torch import native
from evflow_tpu_torch.models import optics as P
from tests.conftest import DATA_DIR

torch.set_num_threads(2)

DENSE_TOL = dict(rtol=1e-3, atol=0.02)


# ---------------------------------------------------------------- helpers

def _assert_tables_equal(got, want, rtol=1e-6):
    """idx and count equal; dist and core_dist inf where JAX's are, else
    within rtol."""
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
        np.testing.assert_allclose(g, w, rtol=rtol, atol=0, err_msg=name)


def _sets(table):
    idx, dist = np.asarray(table.idx), np.asarray(table.dist)
    return [set(i[np.isfinite(d)].tolist()) for i, d in zip(idx, dist)]


def _d64(pts):
    pts = np.asarray(pts, np.float64)
    return np.sqrt(((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1))


def _assert_dense_close(got, want, pts, eps, rows=None, counts=True):
    """Dense tables on float data: the sets equal once the pairs within
    DENSE_TOL of eps are left out, counts (unless not asked for) equal on
    rows without such a pair, core distances within DENSE_TOL."""
    d = _d64(pts)
    edge = np.abs(d - eps) <= DENSE_TOL["atol"] + DENSE_TOL["rtol"] * eps
    gs, ws = _sets(got), _sets(want)
    rows = range(len(pts)) if rows is None else rows
    for i in rows:
        off = set(np.nonzero(edge[i])[0].tolist())
        assert gs[i] - off == ws[i] - off, i
    clear = ~edge.any(1)
    if counts:
        np.testing.assert_array_equal(np.asarray(got.count)[clear],
                                      np.asarray(want.count)[clear])
    kg, kw = np.asarray(got.core_dist), np.asarray(want.core_dist)
    fin = np.isfinite(kw) & clear
    np.testing.assert_array_equal(np.isfinite(kg)[clear], np.isfinite(kw)[clear])
    np.testing.assert_allclose(kg[fin], kw[fin], **DENSE_TOL)


def _by_index(rd, n):
    r = np.full(n, -2.0)
    for x in rd:
        r[x.point_index] = x.reach_dist
    return r


def _assert_same_sweep(got, want):
    """Integer coordinates: the same visit order, reach within rtol 1e-6."""
    assert [r.point_index for r in got] == [r.point_index for r in want]
    np.testing.assert_allclose([r.reach_dist for r in got], [r.reach_dist for r in want],
                               rtol=1e-6, atol=0)


def _assert_reach_agree(got, want, n, threshold):
    """Float clouds: the JAX tests' criteria (module docstring)."""
    da, db = _by_index(want, n), _by_index(got, n)
    unreached = da < 0
    assert (unreached == (db < 0)).all()
    close = np.isclose(db[~unreached], da[~unreached], rtol=1e-3, atol=0.05)
    assert close.size == 0 or close.mean() >= 0.995, close.mean()
    ca = J.get_cluster_indices(want, threshold)
    cb = P.get_cluster_indices(got, threshold)
    assert sorted(map(sorted, ca)) == sorted(map(sorted, cb))


def _clear_of_eps(pts, eps):
    assert np.abs(_d64(pts) - eps).min() > 1e-5 * eps


# ---------------------------------------------------------------- clustering

THREE_GROUPS = np.array([[100, 100], [102, 100], [101, 101],
                         [-1, 0], [1, 0], [0, 1],
                         [-100, -100], [-102, -100], [-101, -101]], np.float64)


def test_clustering_test_1():  # test_main.cpp:12-31
    rd = P.compute_reachability_dists(THREE_GROUPS, 2, 10, device="cpu")
    _assert_same_sweep(rd, J.compute_reachability_dists(THREE_GROUPS, 2, 10))
    clusters = P.get_cluster_indices(rd, 10)
    assert [sorted(c) for c in clusters] == [[0, 1, 2], [3, 4, 5], [6, 7, 8]]


def test_clustering_test_2_auto_epsilon():  # test_main.cpp:34-57
    rd = P.compute_reachability_dists(THREE_GROUPS, 2, device="cpu")
    _assert_same_sweep(rd, J.compute_reachability_dists(THREE_GROUPS, 2))
    clusters = P.get_cluster_indices(rd, 2)
    assert [sorted(c) for c in clusters] == [[0, 1, 2], [3, 4, 5], [6, 7, 8]]


# ---------------------------------------------------------------- epsilon

def test_epsilon_estimation_1():  # test_main.cpp:91-102
    points = np.array([[0, 0], [1, 0], [0, 1], [10, 0], [0, 10],
                       [6, 6], [4, 4], [10, 10], [9, 10], [10, 9]], np.float64)
    eps = P.epsilon_estimation(points, 3)
    assert eps == J.epsilon_estimation(points, 3)
    assert 3.09019 < eps < 3.090196


def test_epsilon_estimation_2():  # test_main.cpp:103-114
    points = np.array([[0, 0, 0], [1, 0, 0], [0, 0, 1], [0, 1, 0],
                       [5, 0, 0], [0, 5, 0], [0, 0, 5], [5, 5, 5]], np.float64)
    eps = P.epsilon_estimation(points, 3)
    assert eps == J.epsilon_estimation(points, 3)
    assert 2.236750 < eps < 2.236751


# ---------------------------------------------------------------- chi tests

CHI1 = [(1, 10.0), (2, 9.0), (3, 9.0), (4, 5.0), (5, 5.49), (6, 5.0),
        (7, 6.5), (8, 3.0), (9, 2.9), (10, 2.8), (11, 10.0), (12, 12.0)]
CHI3 = [(1, 11.0), (2, 9.0), (3, 9.0), (4, 5.0), (5, 5.49), (6, 5.0),
        (7, 6.5), (8, 3.0), (9, 2.9), (10, 2.8), (11, 10.0), (12, 10.0),
        (13, 4.0), (14, 4.1), (15, 4.0), (16, 3.9), (17, 12.0)]
CHI6 = [(1, 12.0)] + CHI3[1:16]


def _chi11():
    data = np.loadtxt(os.path.join(DATA_DIR, "chi_test_11_reachability.csv"),
                      delimiter=",", skiprows=1)
    return [(int(i), float(d)) for i, d in data]


# (name, reachability pairs, chi, min_pts, steep_area_min_diff, expected)
# from test_main.cpp:117-500 and the committed chi-11 regression vector
CHI_CASES = [
    ("chi_1", CHI1, 0.1, 4, 0.0, [(2, 5), (0, 11), (6, 10)]),
    ("chi_2", CHI1 + [(13, 4.0), (14, 4.1), (15, 4.0), (16, 3.9), (17, 5.0)], 0.1, 4, 0.0,
     [(2, 5), (0, 10), (6, 10), (11, 16)]),
    ("chi_3", CHI3, 0.1, 4, 0.0, [(2, 5), (0, 9), (6, 10), (0, 16), (11, 16)]),
    ("chi_4", [(1, 12.0)] + CHI3[1:16] + [(17, 11.0)], 0.1, 4, 0.0,
     [(2, 5), (0, 9), (6, 10), (0, 16), (11, 16)]),
    ("chi_5", [(1, 12.0)] + CHI3[1:], 0.1, 4, 0.0,
     [(2, 5), (0, 9), (6, 10), (0, 16), (11, 16)]),
    ("chi_6", CHI6, 0.1, 4, 0.0, [(2, 5), (0, 9), (6, 10), (2, 15), (11, 15)]),
    ("chi_7", CHI6[:6] + [(7, 11.0)] + CHI6[7:10] + [(11, 9.89), (12, 9.89)] + CHI6[12:],
     0.1, 4, 0.0, [(0, 5), (6, 9), (6, 15), (11, 15)]),
    ("chi_8", CHI6[:6] + [(7, 11.0)] + CHI6[7:10] + [(11, 9.89), (12, 9.91)] + CHI6[12:],
     0.1, 4, 0.0, [(0, 5), (6, 9), (11, 15)]),
    ("chi_9", [(0, 5.0), (1, 5.49), (2, 5.0), (3, 11.0), (4, 3.0), (5, 2.9), (6, 2.8),
               (7, 9.89), (8, 9.9), (9, 4.0), (10, 4.1), (11, 4.0), (12, 3.9)], 0.1, 4, 0.0,
     [(0, 2), (3, 6), (3, 12), (8, 12)]),
    ("chi_10", [(0, 5.0), (1, 5.49), (2, 5.0), (3, 11.0), (4, 3.0), (5, 2.9), (6, 2.8),
                (7, 9.89), (8, 9.91), (9, 4.0), (10, 4.1), (11, 4.0), (12, 3.9)], 0.1, 4, 0.0,
     [(0, 2), (3, 6), (8, 12)]),
    ("chi_11_regression_vector_a", None, 0.02, 5, 0.15,
     [(155, 162), (203, 225), (295, 299), (300, 304), (271, 358), (270, 372),
      (150, 407), (422, 493), (590, 607), (626, 642), (412, 684), (700, 711)]),
    ("chi_11_regression_vector_b", None, 0.1, 8, 0.02,
     [(155, 160), (208, 217), (276, 321), (271, 355), (150, 407), (425, 470),
      (425, 487), (598, 606), (626, 642), (623, 650), (412, 684), (700, 711)]),
]


@pytest.mark.parametrize("name,pairs,chi,min_pts,diff,expected", CHI_CASES,
                         ids=[c[0] for c in CHI_CASES])
def test_chi(name, pairs, chi, min_pts, diff, expected):
    """Equal outputs, and the reference's expected clusters."""
    pairs = _chi11() if pairs is None else pairs
    got = P.get_chi_clusters_flat([P.ReachabilityDist(i, d) for i, d in pairs],
                                  chi, min_pts, diff)
    want = J.get_chi_clusters_flat([J.ReachabilityDist(i, d) for i, d in pairs],
                                   chi, min_pts, diff)
    assert got == want == expected


# ---------------------------------------------------------------- tree tests

def _tree(node):
    return (node.data, [_tree(c) for c in node.children])


@pytest.mark.parametrize("flat", [[(2, 5), (0, 11), (6, 10)],
                                  [(1, 2), (0, 5), (3, 4), (0, 20), (7, 9)]])
def test_cluster_tree(flat):  # chi_cluster_tree_tests, test_main.cpp:504-566
    got, want = P.flat_clusters_to_tree(flat), J.flat_clusters_to_tree(flat)
    assert [_tree(t) for t in got] == [_tree(t) for t in want]
    assert [(t.depth(), t.size(), t.flatten()) for t in got] == \
        [(t.depth(), t.size(), t.flatten()) for t in want]
    assert len(got) == 1


def test_cluster_tree_nested():
    root, = P.flat_clusters_to_tree([(1, 2), (0, 5), (3, 4), (0, 20), (7, 9)])
    assert root.data == (0, 20)
    assert sorted(c.data for c in root.children) == [(0, 5), (7, 9)]
    assert root == J.flat_clusters_to_tree([(1, 2), (0, 5), (3, 4), (0, 20), (7, 9)])[0]


# ---------------------------------------------------------------- integration

def test_integration_three_gaussian_clusters():
    rng = np.random.default_rng(3)
    pts = np.concatenate([rng.normal((0, 0), 1.0, (50, 2)),
                          rng.normal((30, 0), 1.0, (50, 2)),
                          rng.normal((0, 30), 1.0, (50, 2))])
    rd = P.compute_reachability_dists(pts, min_pts=5, epsilon=5.0, device="cpu")
    _assert_reach_agree(rd, J.compute_reachability_dists(pts, min_pts=5, epsilon=5.0),
                        len(pts), 5.0)
    clusters = [c for c in P.get_cluster_indices(rd, 5.0) if len(c) >= 10]
    assert sorted(len(c) for c in clusters) == [50, 50, 50]


def test_export_reachability(tmp_path):
    """The same file, byte for byte, with and without replace_nodists."""
    rd = [P.ReachabilityDist(i, d) for i, d in CHI1[:4]] + [P.ReachabilityDist(13, -1.0)]
    for replace in (True, False):
        P.export_reachability_dists(rd, str(tmp_path / "p.csv"), replace)
        J.export_reachability_dists([J.ReachabilityDist(*r) for r in rd],
                                    str(tmp_path / "j.csv"), replace)
        got = (tmp_path / "p.csv").read_bytes()
        assert got == (tmp_path / "j.csv").read_bytes()
        lines = got.decode().strip().splitlines()
        assert lines[0] == "PointIndex;ReachabilityDistance" and len(lines) == 6


# ------------------------------------------------------- grid neighbor search

def test_grid_neighbors_match_dense_integer_coords():
    """Integer coordinates: the port's grid and dense tables each equal
    JAX's, the grid's sets equal the dense table's, and the grid and dense
    sweeps give the same order."""
    pts = np.random.default_rng(7).integers(0, 200, (1500, 2)).astype(np.float64)
    eps, min_pts = 7.0, 6
    g = P.compute_neighbors_grid(pts, eps, min_pts, device="cpu")
    t = P.compute_neighbors(pts, eps, min_pts, device="cpu")
    _assert_tables_equal(g, J.compute_neighbors_grid(pts, eps, min_pts), rtol=0)
    _assert_tables_equal(t, J.compute_neighbors(pts, eps, min_pts), rtol=0)
    np.testing.assert_array_equal(g.count.numpy(), t.count.numpy())
    np.testing.assert_array_equal(g.core_dist.numpy(), t.core_dist.numpy())
    assert _sets(g) == _sets(t)
    rg = P.compute_reachability_dists(pts, min_pts, eps, method="grid", device="cpu")
    rd = P.compute_reachability_dists(pts, min_pts, eps, method="dense", device="cpu")
    _assert_same_sweep(rg, J.compute_reachability_dists(pts, min_pts, eps, method="grid"))
    _assert_same_sweep(rd, J.compute_reachability_dists(pts, min_pts, eps, method="dense"))
    assert [r.point_index for r in rg] == [r.point_index for r in rd]


def test_grid_neighbors_match_float64_oracle():
    rng = np.random.default_rng(11)
    pts = rng.uniform(0, 100, (1200, 2))
    min_pts = 8
    eps = P.epsilon_estimation(pts, min_pts)
    _clear_of_eps(pts, eps)
    g = P.compute_neighbors_grid(pts, eps, min_pts, device="cpu")
    _assert_tables_equal(g, J.compute_neighbors_grid(pts, eps, min_pts))
    D = _d64(pts)
    cnt = (D <= eps).sum(1)
    core = np.where(cnt >= min_pts, np.sort(D, axis=1)[:, min_pts - 1], np.inf)
    np.testing.assert_array_equal(g.count.numpy(), cnt)
    np.testing.assert_allclose(g.core_dist.numpy(), core, atol=1e-4)


def test_grid_neighbors_3d_and_fallbacks():
    rng = np.random.default_rng(13)
    pts = rng.uniform(0, 50, (600, 3))
    eps = P.epsilon_estimation(pts, 4)
    _clear_of_eps(pts, eps)
    g = P.compute_neighbors_grid(pts, eps, 4, device="cpu")
    _assert_tables_equal(g, J.compute_neighbors_grid(pts, eps, 4))
    np.testing.assert_array_equal(
        g.count.numpy(), P.compute_neighbors(pts, eps, 4, device="cpu").count.numpy())
    pts6 = rng.uniform(0, 10, (100, 6))
    assert P.compute_neighbors_grid(pts6, 2.0, 3, device="cpu") is None
    g6 = P.compute_neighbors_grid(pts6, 2.0, 3, allow_projected=True, device="cpu")
    _assert_tables_equal(g6, J.compute_neighbors_grid(pts6, 2.0, 3, allow_projected=True))
    _assert_dense_close(P.compute_neighbors(pts6, 2.0, 3, device="cpu"),
                        J.compute_neighbors(pts6, 2.0, 3), pts6, 2.0)
    rd = P.compute_reachability_dists(pts6, 3, 2.0, method="auto", device="cpu")
    _assert_reach_agree(rd, J.compute_reachability_dists(pts6, 3, 2.0, method="auto"),
                        100, 2.0)
    dense_pts = np.concatenate([np.zeros((300, 2)), rng.uniform(0, 9, (9, 2))])
    assert P.compute_neighbors_grid(dense_pts, 3.0, 3, max_bucket=128, device="cpu") is None
    wide = rng.uniform(0, 1, (50, 2))
    assert P.compute_neighbors_grid(wide, 1e-5, 3, device="cpu") is None
    with pytest.raises(ValueError, match="grid neighbor search does not apply"):
        P.compute_reachability_dists(wide, 3, 1e-5, method="grid", device="cpu")


@pytest.mark.parametrize("dim", [1, 2, 3])
def test_cellpair_matches_grid_exactly(dim):
    """The cell-pair table equals JAX's, and its counts, core distances and
    sets equal the port's grid table's; with max_neighbors 16 it selects
    (sorted, ties to the lower slot) and still equals JAX's."""
    pts = uniform_cloud(2000, dim, 1000.0, seed=4)
    eps = J.epsilon_estimation(pts, 10)
    _clear_of_eps(pts, eps)
    g = P.compute_neighbors_grid(pts, eps, 10, max_neighbors=256, device="cpu")
    cp = P.compute_neighbors_cellpair(pts, eps, 10, max_neighbors=256, device="cpu")
    _assert_tables_equal(cp, J.compute_neighbors_cellpair(pts, eps, 10, max_neighbors=256))
    np.testing.assert_array_equal(g.count.numpy(), cp.count.numpy())
    np.testing.assert_allclose(g.core_dist.numpy(), cp.core_dist.numpy(), rtol=1e-6)
    assert _sets(g) == _sets(cp)
    sel = P.compute_neighbors_cellpair(pts, eps, 10, max_neighbors=16, device="cpu")
    _assert_tables_equal(sel, J.compute_neighbors_cellpair(pts, eps, 10, max_neighbors=16))
    if sel.idx.shape[1] == 16:      # selected (3^d * bucket > 64): sorted
        assert bool((sel.dist[:, 1:] >= sel.dist[:, :-1]).all())


def test_cellpair_declines_and_raises():
    """Every guard that returns None in JAX returns None here; method
    'cellpair' turns a decline into ValueError."""
    rng = np.random.default_rng(13)
    cases = [(rng.uniform(0, 10, (100, 5)), 2.0, 3, {}),           # d > 4
             (np.zeros((0, 2)), 1.0, 3, {}),                        # no points
             (rng.uniform(0, 1, (50, 2)), 1e-5, 3, {}),             # slot space >> N
             (np.concatenate([np.zeros((300, 2)), rng.uniform(0, 9, (9, 2))]), 3.0, 3,
              dict(max_bucket=128)),                                # over-full cell
             (rng.uniform(0, 10, (400, 2)), 2.0, 40, dict(max_neighbors=16)),
             (rng.normal(0, 5, (1500, 2)), 12.0, 10, dict(max_neighbors=512))]  # select > 256
    for pts, eps, min_pts, kw in cases:
        assert P.compute_neighbors_cellpair(pts, eps, min_pts, device="cpu", **kw) is None
        assert J.compute_neighbors_cellpair(pts, eps, min_pts, **kw) is None
    with pytest.raises(ValueError, match="cell-pair neighbor search does not apply"):
        P.compute_reachability_dists(cases[0][0], 3, 2.0, method="cellpair", device="cpu")


@pytest.mark.parametrize("dim", [5, 6])
def test_projected_grid_matches_dense_high_dim(dim):
    pts = uniform_cloud(1200, dim, 1000.0, seed=3)
    eps = J.epsilon_estimation(pts, 10)
    g = P.compute_neighbors_grid(pts, eps, 10, max_neighbors=512, allow_projected=True,
                                 device="cpu")
    assert g is not None
    dense = P.compute_neighbors(pts, eps, 10, max_neighbors=512, device="cpu")
    jdense = J.compute_neighbors(pts, eps, 10, max_neighbors=512)
    _assert_dense_close(dense, jdense, pts, eps)
    _assert_dense_close(g, jdense, pts, eps)


@pytest.mark.parametrize("dim", [5, 6])
def test_projected_grid_g4_exact_sets(dim):
    """Projected grids at g = 3 and 4 equal JAX's, and their sets equal a
    fp32 difference-form oracle."""
    pts = uniform_cloud(1200, dim, 1000.0, seed=4)
    eps = J.epsilon_estimation(pts, 10)
    _clear_of_eps(pts, eps)
    for g in (3, 4):
        t = P.compute_neighbors_grid(pts, eps, 10, max_neighbors=512, allow_projected=True,
                                     proj_dims=g, device="cpu")
        _assert_tables_equal(t, J.compute_neighbors_grid(
            pts, eps, 10, max_neighbors=512, allow_projected=True, proj_dims=g))
        ti = t.idx.numpy()
        for i in range(0, len(pts), 53):
            d32 = np.sqrt(np.sum((pts - pts[i]).astype(np.float32) ** 2, axis=1))
            oracle = set(np.where(d32 <= np.float32(eps))[0].tolist())
            assert {int(v) for v in ti[i] if v >= 0} == oracle, (dim, g, i)


def test_neighbor_cap_truncation():
    """(a) The auto-raise: one recompute with K raised, its RuntimeWarning
    word for word as JAX's, and the reach then equal to the uncapped run's.
    (b) The truncated table's profile stays within JAX's bounds of the full
    one. (c) A neighborhood past the raise cap: both warnings, as JAX's."""
    rng = np.random.default_rng(11)
    n = 700
    # on a 1/8 grid every distance term is exact in fp32, so both packages
    # count the same neighborhoods and warn with the same numbers
    pts = np.round(rng.normal(0.0, 5.0, (n, 2)) * 8) / 8
    eps, min_pts = 12.0, 10
    t_small = P.compute_neighbors(pts, eps, min_pts, max_neighbors=128, device="cpu")
    t_full = P.compute_neighbors(pts, eps, min_pts, max_neighbors=n, device="cpu")
    _assert_tables_equal(t_full, J.compute_neighbors(pts, eps, min_pts, max_neighbors=n))
    assert int(t_full.count.max()) > 256

    def run(mod, **kw):
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            rd = mod.compute_reachability_dists(pts, min_pts, eps, method="dense",
                                                use_native=False, **kw)
        return rd, [str(x.message) for x in rec if x.category is RuntimeWarning]

    got, got_w = run(P, max_neighbors=128, device="cpu")
    want, want_w = run(J, max_neighbors=128)
    assert got_w == want_w and "recomputing with max_neighbors" in got_w[0], got_w
    full, _ = run(P, max_neighbors=n, device="cpu")
    np.testing.assert_allclose(_by_index(got, n), _by_index(full, n), rtol=0, atol=1e-12)
    _assert_reach_agree(got, want, n, eps / 2)

    def reach(table):
        return P.sweep_python(*P.table_to_host(table))[1]

    r_small, r_full = reach(t_small), reach(t_full)
    both = (r_small >= 0) & (r_full >= 0)
    assert (both == (r_full >= 0)).all()
    err = np.abs(r_small[both] - r_full[both])
    assert float(np.mean(err / np.maximum(r_full[both], 1e-9))) < 0.02
    assert float(np.max(err)) <= eps

    clump = np.random.default_rng(2).integers(0, 30, (1100, 2)).astype(np.float64)
    msgs = []
    for mod, kw in ((P, dict(device="cpu")), (J, {})):
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            mod.compute_reachability_dists(clump, 5, 50.0, max_neighbors=256,
                                           method="dense", **kw)
        msgs.append([str(x.message) for x in rec if x.category is RuntimeWarning])
    assert msgs[0] == msgs[1] and len(msgs[0]) == 2, msgs
    assert "recomputing with max_neighbors=1024" in msgs[0][0]
    assert "truncated: cap 1024 < max true neighborhood 1100" in msgs[0][1]


def test_grid_full_window_and_4d_grid_match_dense():
    """full_window tables equal JAX's, and their sets equal the dense
    table's; the full-window sweep's reach per point agrees with the dense
    sweep's and with JAX's."""
    for dim in (2, 3, 4):
        pts = uniform_cloud(1200, dim, 1000.0, seed=5)
        eps = J.epsilon_estimation(pts, 10)
        fw = P.compute_neighbors_grid(pts, eps, 10, max_neighbors=16, full_window=True,
                                      device="cpu")
        _assert_tables_equal(fw, J.compute_neighbors_grid(pts, eps, 10, max_neighbors=16,
                                                          full_window=True))
        dense = J.compute_neighbors(pts, eps, 10, max_neighbors=1024)
        _assert_dense_close(fw, dense, pts, eps, rows=range(0, len(pts), 71))
    pts = uniform_cloud(1500, 3, 1000.0, seed=6)
    eps = J.epsilon_estimation(pts, 10)
    rg = P.compute_reachability_dists(pts, 10, eps, method="grid", full_window=True,
                                      device="cpu")
    rd = P.compute_reachability_dists(pts, 10, eps, method="dense", max_neighbors=1024,
                                      device="cpu")
    ga, da = _by_index(rg, len(pts)), _by_index(rd, len(pts))
    np.testing.assert_allclose(ga, da, rtol=1e-3, atol=1e-5)
    _assert_reach_agree(rg, J.compute_reachability_dists(pts, 10, eps, method="grid",
                                                         full_window=True), len(pts), eps)


def test_4d_grid_select_mode_and_entry_cap():
    pts4 = uniform_cloud(1500, 4, 1000.0, seed=7)
    eps = J.epsilon_estimation(pts4, 10)
    g = P.compute_neighbors_grid(pts4, eps, 10, max_neighbors=64, device="cpu")
    _assert_tables_equal(g, J.compute_neighbors_grid(pts4, eps, 10, max_neighbors=64))
    assert g.idx.shape[1] <= 81 * 64
    _assert_dense_close(g, J.compute_neighbors(pts4, eps, 10, max_neighbors=1024), pts4, eps,
                        rows=range(0, len(pts4), 37))
    g = P.compute_neighbors_grid(pts4, eps, 10, max_neighbors=16, full_window=True,
                                 full_window_entry_cap=1000, device="cpu")
    _assert_tables_equal(g, J.compute_neighbors_grid(pts4, eps, 10, max_neighbors=16,
                                                     full_window=True,
                                                     full_window_entry_cap=1000))
    assert g.idx.shape[1] == 16
    pts3 = uniform_cloud(1500, 3, 1000.0, seed=7)
    eps3 = J.epsilon_estimation(pts3, 10)
    g3 = P.compute_neighbors_grid(pts3, eps3, 10, max_neighbors=16, full_window=True,
                                  full_window_entry_cap=1000, device="cpu")
    assert g3.idx.shape[1] == 16


# ------------------------------------------- JAX's TPU work-arounds: dense here

@pytest.mark.parametrize("d,n", [(4, 1500), (6, 1500), (2, 1200)])
def test_two_stage_dense_equals_dense_neighbor_sets(d, n):
    """JAX's contract for dense2 (sets equal to the dense table's, count
    no less than the true count, core within DENSE_TOL), held by the
    port's dense2 against JAX's dense2 and dense tables."""
    pts = uniform_cloud(n, d, seed=3)
    eps = J.epsilon_estimation(pts, 10)
    got = P.compute_neighbors_2stage(pts, eps, 10, 128, device="cpu")
    want = J.compute_neighbors_2stage(pts, eps, 10, 128)
    dense = J.compute_neighbors(pts, eps, 10, 128)
    _assert_dense_close(got, dense, pts, eps)
    _assert_dense_close(got, want, pts, eps, counts=False)
    assert (np.asarray(want.count) >= got.count.numpy()).all()
    d = _d64(pts)
    clear = ~(np.abs(d - eps) <= 1e-4 * eps).any(1)
    np.testing.assert_array_equal(got.count.numpy()[clear], (d <= eps).sum(1)[clear])


def test_two_stage_dense_reachability_end_to_end():
    rng = np.random.default_rng(5)
    cents = rng.uniform(0, 800, (6, 4))
    pts = (cents[rng.integers(0, 6, 1200)] + rng.normal(0, 10, (1200, 4))).astype(np.float64)
    got = P.compute_reachability_dists(pts, 8, 40.0, method="dense2", device="cpu")
    _assert_reach_agree(got, J.compute_reachability_dists(pts, 8, 40.0, method="dense2"),
                        len(pts), 20.0)
    _assert_reach_agree(got, J.compute_reachability_dists(pts, 8, 40.0, method="dense"),
                        len(pts), 20.0)


@pytest.mark.parametrize("d,n", [(4, 1500), (6, 1500), (2, 1200)])
def test_certified_equals_dense_neighbor_sets(d, n):
    """The certified table's contract, with JAX's test hooks passed (and
    ignored): sets equal to the dense table's, count the true count, core
    within DENSE_TOL of JAX's certified table."""
    pts = uniform_cloud(n, d, seed=3)
    eps = J.epsilon_estimation(pts, 10)
    want = J.compute_neighbors_certified(pts, eps, 10, 128)
    dense = J.compute_neighbors(pts, eps, 10, 128)
    stats = {}
    variants = [P.compute_neighbors_certified(pts, eps, 10, 128, _stats=stats, device="cpu"),
                P.compute_neighbors_certified(pts, eps, 10, 128, _force_retry=True,
                                              straggler_block=512, device="cpu"),
                P.compute_neighbors_certified(pts, eps, 10, 128, _force_fallback=True,
                                              sort_block=128, device="cpu")]
    for got in variants:
        _assert_dense_close(got, dense, pts, eps)
        _assert_dense_close(got, want, pts, eps)
        _assert_tables_equal(got, variants[0], rtol=0)


def test_certified_reachability_end_to_end():
    """'certified' and 'auto' at d = 5 (where the grid declines) against
    JAX's certified and auto runs."""
    rng = np.random.default_rng(5)
    cents = rng.uniform(0, 800, (6, 5))
    pts = (cents[rng.integers(0, 6, 1200)] + rng.normal(0, 10, (1200, 5))).astype(np.float64)
    for method in ("certified", "auto"):
        got = P.compute_reachability_dists(pts, 8, 40.0, method=method, device="cpu")
        _assert_reach_agree(got, J.compute_reachability_dists(pts, 8, 40.0, method=method),
                            len(pts), 20.0)
        _assert_reach_agree(got, J.compute_reachability_dists(pts, 8, 40.0, method="dense"),
                            len(pts), 20.0)


def test_certified_fallback_overflow_rows():
    """Rows with more than k neighbors hold the exact nearest k and the
    exact count, as JAX's certified table does (its float64 oracle)."""
    rng = np.random.default_rng(7)
    pts = np.concatenate([rng.normal(500.0, 1.0, (60, 2)),
                          rng.uniform(0, 1000, (60, 2))]).astype(np.float64)
    eps, k = 25.0, 16
    got = P.compute_neighbors_certified(pts, eps, 5, max_neighbors=k, device="cpu")
    want = J.compute_neighbors_certified(pts, eps, 5, max_neighbors=k)
    ib, db, cb = got.idx.numpy(), got.dist.numpy(), got.count.numpy()
    d64 = _d64(pts)
    within = d64 <= eps
    c64 = within.sum(1)
    np.testing.assert_array_equal(cb, np.asarray(want.count))
    for i in range(len(pts)):
        if c64[i] > k:
            assert cb[i] == c64[i], i
            np.testing.assert_allclose(np.sort(db[i]), np.sort(d64[i][within[i]])[:k],
                                       rtol=1e-5, atol=1e-3)
        else:
            assert set(ib[i][ib[i] >= 0]) == set(np.nonzero(within[i])[0]), i
    assert (c64 > k).any()


def test_epsilon_estimation_high_dim_no_overflow():
    for d in (6, 100, 128, 512):
        pts = uniform_cloud(1000, d, 1000.0, seed=1)
        e = P.epsilon_estimation(pts, 10)
        assert np.isfinite(e) and e > 0.0 and e == J.epsilon_estimation(pts, 10), d


# ------------------------------------------------------- what the port adds

def test_dense_selection_breaks_ties_to_the_lower_index():
    """Points on a circle of radius 5 around the origin (a Pythagorean
    triple, so every distance is exactly 5) and more of them than K: the
    kept neighbors are the lowest indices, as lax.top_k keeps them."""
    ring = [(5, 0), (0, 5), (-5, 0), (0, -5), (3, 4), (4, 3), (-3, 4), (-4, 3),
            (3, -4), (4, -3), (-3, -4), (-4, -3)]
    pts = np.array([(0, 0)] + ring * 3 + [(40, 40)], np.float64)
    rng = np.random.default_rng(0)
    pts = pts[np.concatenate([[0], 1 + rng.permutation(len(pts) - 1)])]
    got = P.compute_neighbors(pts, 6.0, 3, max_neighbors=8, device="cpu")
    want = J.compute_neighbors(pts, 6.0, 3, max_neighbors=8)
    _assert_tables_equal(got, want, rtol=0)
    tied = np.nonzero(np.isclose(_d64(pts)[0], 5.0))[0]
    assert len(tied) == 36 and int(got.count[0]) == 37
    assert got.idx[0].tolist() == [0] + sorted(tied.tolist())[:7]


def _random_table(seed, n=300, k=12):
    """A table with -1/inf pads scattered through the rows, integer
    distances (many ties) and some undefined core distances."""
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.permutation(n)[:k] for _ in range(n)]).astype(np.int32)
    dist = rng.integers(0, 6, (n, k)).astype(np.float64)
    pad = rng.random((n, k)) < 0.3
    idx[pad] = -1
    dist[pad] = np.inf
    dist[rng.random((n, k)) < 0.05] = np.inf           # a live index, no distance
    core = rng.integers(0, 4, n).astype(np.float64)
    core[rng.random(n) < 0.2] = np.inf
    return idx, dist, core


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sweeps_agree(seed):
    """The port's native sweep, its Python loop and the JAX package's
    native sweep give the same order and reach."""
    idx, dist, core = _random_table(seed)
    order, reach = native.optics_sweep(idx, dist, core)
    order_py, reach_py = P.sweep_python(idx, dist, core)
    want = jnative.optics_sweep(idx, dist, core)
    assert want is not None
    np.testing.assert_array_equal(order, order_py)
    np.testing.assert_array_equal(reach, reach_py)
    np.testing.assert_array_equal(order, want[0])
    np.testing.assert_array_equal(reach, want[1])
    assert sorted(order.tolist()) == list(range(len(core)))


def test_sweep_native_build_failure_raises(monkeypatch, tmp_path):
    """use_native requires the build: a source g++ cannot compile raises."""
    bad = tmp_path / "optics_sweep.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build()


def test_sharded_raises_until_parallel_is_ported():
    """method="sharded" runs now that parallel/ is ported: outside a
    process group it is one rank, and its table and sweep equal the dense
    method's."""
    dense = P.neighbor_table(THREE_GROUPS, 2, 10, method="dense", device="cpu")
    sharded = P.neighbor_table(THREE_GROUPS, 2, 10, method="sharded", device="cpu")
    for a, b in zip(sharded, dense):
        assert torch.equal(a, b)
    assert P.compute_reachability_dists(THREE_GROUPS, 2, 10, method="sharded", device="cpu") \
        == P.compute_reachability_dists(THREE_GROUPS, 2, 10, method="dense", device="cpu")


def test_every_public_name_of_the_jax_module():
    public = [name for name, obj in vars(J).items()
              if not name.startswith("_") and getattr(obj, "__module__", None) == J.__name__]
    assert len(public) >= 17
    assert [name for name in public if not hasattr(P, name)] == []
