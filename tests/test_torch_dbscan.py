"""The port's DBSCAN (dense and grid) and the point-cloud stages of app C
(voxel downsample, RANSAC plane, plane removal) against the JAX package,
on the cases of tests/test_dbscan.py and on integer pixel coordinates.

Tolerances: DBSCAN's labels, num_clusters, core_mask and iterations are
equal. On float data a pair within an ulp of eps could round either way,
so each float case first asserts that no pair lies within 1e-4 of eps; on
integer pixels every distance term is exact and nothing needs a margin.
Voxel counts, validity and occupied buckets equal; centroids within
1e-6. RANSAC on JAX's own hypothesis indices: the same plane (coeffs
within 1e-6), the same inliers and inlier count."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from evflow_tpu.config import DBSCANConfig
from evflow_tpu.models import dbscan as jdb, pointcloud as jpc
from evflow_tpu.ops import distance as jdist
from evflow_tpu_torch import kernels
from evflow_tpu_torch.models import dbscan, optics, pointcloud
from evflow_tpu_torch.ops import distance
from evflow_tpu_torch.parallel import batch

torch.set_num_threads(2)

CFG = DBSCANConfig(eps=8.0, core_min_pts=10, min_cluster_size=40, max_cluster_size=10_000)
GRID_CFG = DBSCANConfig(eps=6.0, core_min_pts=8, min_cluster_size=50, max_cluster_size=10000)


def _blobs(seed=0):
    rng = np.random.default_rng(seed)
    return np.concatenate([
        rng.normal((0, 0), 2.0, (120, 2)),
        rng.normal((100, 0), 2.0, (150, 2)),
        rng.normal((0, 100), 2.0, (80, 2)),
        rng.uniform(-50, 150, (30, 2)),
    ]).astype(np.float32)


def _grid_blobs():
    """tests/test_dbscan.py's grid scene at a seed whose pairs stay 1e-4
    clear of eps 6 (its seed 4 has a pair 1.1e-5 from it)."""
    rng = np.random.default_rng(6)
    return np.concatenate([
        rng.normal((0, 0), 2.0, (300, 2)),
        rng.normal((100, 0), 2.0, (250, 2)),
        rng.normal((0, 100), 2.0, (200, 2)),
        rng.uniform(0, 100, (30, 2)),
    ]).astype(np.float32)


def _pixels(seed=5, n=1500):
    """Event-like integer pixels: three dense blobs (many points share a
    pixel) and scattered noise, over 400 x 300 pixels."""
    rng = np.random.default_rng(seed)
    pts = np.concatenate([rng.normal(c, 6.0, (n // 3, 2))
                          for c in ((100, 100), (300, 200), (200, 60))]
                         + [rng.uniform(0, (400, 300), (n // 10, 2))])
    return np.clip(np.round(pts), 0, 399).astype(np.float32)


def _clear_of_eps(pts, eps):
    d = np.sqrt(((pts[:, None, :].astype(np.float64) - pts[None, :, :]) ** 2).sum(-1))
    assert np.abs(d - eps).min() > 1e-4


def _assert_same(got, want):
    for name in ("labels", "num_clusters", "core_mask", "iterations"):
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)


def _as_sets(labels):
    out = {}
    for i, label in enumerate(np.asarray(labels)):
        if label >= 0:
            out.setdefault(int(label), set()).add(i)
    return out


@pytest.mark.parametrize("case", ["oracle", "noise", "size-filter", "valid-mask"])
def test_dbscan_matches_jax(case):
    """tests/test_dbscan.py's dense cases; the oracle case also against the
    BFS oracle's clusters and order."""
    seed = {"oracle": 0, "noise": 1, "size-filter": 2, "valid-mask": 3}[case]
    pts = _blobs(seed)
    cfg = CFG if case != "size-filter" else DBSCANConfig(
        eps=8.0, core_min_pts=10, min_cluster_size=100, max_cluster_size=10_000)
    _clear_of_eps(pts, cfg.eps)
    valid = None
    if case == "valid-mask":
        valid = np.ones(len(pts), bool)
        valid[:60] = False
    got = dbscan.dbscan(torch.as_tensor(pts), None if valid is None else torch.as_tensor(valid),
                        cfg=cfg)
    want = jdb.dbscan(jnp.asarray(pts), None if valid is None else jnp.asarray(valid), cfg=cfg)
    _assert_same(got, want)
    if case == "oracle":
        exp = jdb.dbscan_reference_numpy(pts, cfg)
        sets = _as_sets(got.labels.numpy())
        assert [sets[k] for k in range(len(exp))] == [set(c) for c in exp]
    if case == "valid-mask":
        assert (got.labels[:60] == -1).all()


@pytest.mark.parametrize("block", [2048, 97])
def test_dbscan_pixels_bit_equal(block):
    """Integer pixels at DBSCANConfig's eps 20 (pairs at exactly eps
    included) with a ragged block: equal to JAX with no margin."""
    pts = _pixels()
    cfg = DBSCANConfig(min_cluster_size=50)
    got = dbscan.dbscan(torch.as_tensor(pts), cfg=cfg, block=block)
    want = jdb.dbscan(jnp.asarray(pts), cfg=cfg, block=block)
    _assert_same(got, want)
    assert int(got.num_clusters) == 3


@pytest.mark.parametrize("max_iters", [1, 2])
def test_dbscan_max_iters_cutoff(max_iters):
    """A chain that needs several rounds, cut at max_iters: the same
    partial labels and iterations as JAX, dense and grid."""
    x = np.arange(400, dtype=np.float32)
    pts = np.stack([x, np.zeros_like(x)], 1)[np.random.default_rng(8).permutation(400)]
    cfg = DBSCANConfig(eps=1.0, core_min_pts=2, min_cluster_size=2, max_cluster_size=10_000)
    full = dbscan.dbscan(torch.as_tensor(pts), cfg=cfg)
    assert int(full.iterations) > 2
    got = dbscan.dbscan(torch.as_tensor(pts), cfg=cfg, max_iters=max_iters)
    _assert_same(got, jdb.dbscan(jnp.asarray(pts), cfg=cfg, max_iters=max_iters))
    assert int(got.iterations) == max_iters
    grid = dbscan.dbscan_grid(pts, cfg=cfg, max_iters=max_iters, device="cpu")
    _assert_same(grid, jdb.dbscan_grid(pts, cfg=cfg, max_iters=max_iters))


def test_dbscan_grid_matches_jax_and_dense():
    """dbscan_grid takes the grid (no fall-back: at the default 256 a blob
    core's row of up to about 300 would overflow) and equals JAX's; its
    partition equals dense dbscan's."""
    pts = _grid_blobs()
    _clear_of_eps(pts, GRID_CFG.eps)
    table = optics.compute_neighbors_grid(pts, GRID_CFG.eps, GRID_CFG.core_min_pts,
                                          max_neighbors=512, device="cpu")
    assert table is not None and int(table.count.max()) <= table.idx.shape[1]
    got = dbscan.dbscan_grid(pts, cfg=GRID_CFG, max_neighbors=512, device="cpu")
    _assert_same(got, jdb.dbscan_grid(pts, cfg=GRID_CFG, max_neighbors=512))
    dense = dbscan.dbscan(torch.as_tensor(pts), cfg=GRID_CFG)
    assert int(dense.num_clusters) == int(got.num_clusters) == 3
    assert ({frozenset(s) for s in _as_sets(dense.labels).values()}
            == {frozenset(s) for s in _as_sets(got.labels).values()})


@pytest.mark.parametrize("max_neighbors", [256, 2048])
def test_dbscan_grid_pixels_and_fallback(max_neighbors):
    """Integer pixels: at max_neighbors 256 a blob core's row overflows the
    table and both packages fall back to dense; at 2048 the grid holds
    every row. Both equal JAX's and give dense dbscan's partition."""
    pts = _pixels(seed=6)
    cfg = DBSCANConfig(min_cluster_size=50)
    table = optics.compute_neighbors_grid(pts, cfg.eps, cfg.core_min_pts,
                                          max_neighbors=max_neighbors, device="cpu")
    overflow = bool((table.count > table.idx.shape[1]).any())
    assert overflow == (max_neighbors == 256)
    got = dbscan.dbscan_grid(pts, cfg=cfg, max_neighbors=max_neighbors, device="cpu")
    _assert_same(got, jdb.dbscan_grid(pts, cfg=cfg, max_neighbors=max_neighbors))
    dense = dbscan.dbscan(torch.as_tensor(pts), cfg=cfg)
    assert ({frozenset(s) for s in _as_sets(dense.labels).values()}
            == {frozenset(s) for s in _as_sets(got.labels).values()})


def test_cpu_eps_tests_launch_nothing():
    """CPU tensors take the panels: dense dbscan, the neighbor counts and
    the one-rank dbscan_sharded launch no kernel (csrc/dbscan_eps.cu runs
    only for CUDA tensors), and give JAX's labels."""
    pts = _pixels()
    cfg = DBSCANConfig(min_cluster_size=50)
    before = dict(kernels.LAUNCHES)
    got = dbscan.dbscan(torch.as_tensor(pts), cfg=cfg)
    counts = distance.radius_neighbor_counts(torch.as_tensor(pts), cfg.eps)
    sharded = batch.dbscan_sharded(pts, cfg=cfg, device="cpu")
    assert kernels.LAUNCHES == before
    _assert_same(got, jdb.dbscan(jnp.asarray(pts), cfg=cfg))
    _assert_same(sharded, jdb.dbscan(jnp.asarray(pts), cfg=cfg))
    np.testing.assert_array_equal(
        counts.numpy(), np.asarray(jdist.radius_neighbor_counts(jnp.asarray(pts), cfg.eps)))


def test_eps_min_label_round_and_rows():
    """eps_min_label on a row block equals those rows of the whole call,
    and with row labels and row core flags it is one propagation round:
    where(row_core, min(row_labels, lowest core label within eps),
    row_labels); eps_counts zeroes the rows that are not valid."""
    pts = torch.as_tensor(_pixels(seed=8))
    rng = np.random.default_rng(9)
    n = pts.shape[0]
    labels = torch.as_tensor(rng.integers(0, n, n).astype(np.int32))
    core = torch.as_tensor(rng.random(n) < 0.5)
    valid = torch.as_tensor(rng.random(n) < 0.9)
    whole = distance.eps_min_label(pts, pts, 20.0, labels, core, block=333)
    rows = slice(100, 700)
    part = distance.eps_min_label(pts[rows], pts, 20.0, labels, core)
    assert torch.equal(part, whole[rows])
    assert int((whole < distance.NO_LABEL).sum()) > n // 2
    rnd = distance.eps_min_label(pts, pts, 20.0, labels, core, labels, core)
    assert torch.equal(rnd, torch.where(core, torch.minimum(labels, whole), labels))
    counts = distance.eps_counts(pts, pts, 20.0, valid, torch.ones_like(valid))
    assert torch.equal(distance.eps_counts(pts, pts, 20.0, valid, valid),
                       torch.where(valid, counts, 0))
    assert bool((counts[~valid] > 0).any())


# ---------------------------------------------------------------- point cloud

def _cloud(seed=7, n=3000):
    """A noisy plane and two blobs, in metres."""
    rng = np.random.default_rng(seed)
    plane = np.stack([rng.uniform(0, 1, n), rng.uniform(0, 1, n),
                      0.3 + rng.normal(0, 0.005, n)], 1)
    blobs = np.concatenate([rng.normal(c, 0.03, (n // 4, 3))
                            for c in ((0.3, 0.3, 0.6), (0.7, 0.6, 0.5))])
    return np.concatenate([plane, blobs]).astype(np.float32)


def _assert_voxels_close(got, want):
    assert int(got.count) == int(want.count)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_allclose(got.points.numpy(), np.asarray(want.points), rtol=0, atol=1e-6)


def test_voxel_example():
    pts = np.array([[0.0, 0, 0], [0.004, 0.004, 0], [0.5, 0.5, 0.5],
                    [0.504, 0.5, 0.5]], np.float32)
    res = pointcloud.voxel_downsample(torch.as_tensor(pts), leaf=0.01)
    assert int(res.count) == 2
    got = res.points[:2].numpy()
    got = got[np.argsort(got[:, 0])]
    np.testing.assert_allclose(got[0], [0.002, 0.002, 0.0], atol=1e-6)
    np.testing.assert_allclose(got[1], [0.502, 0.5, 0.5], atol=1e-6)


@pytest.mark.parametrize("num_buckets", [1 << 16, 1000, 1 << 12])
def test_voxel_matches_jax(num_buckets):
    """Default buckets, a bucket count that is not a power of two (where an
    int64 key would differ from JAX's int32 wrap), and one small enough to
    merge voxels; a validity mask drops some points."""
    pts = _cloud()
    valid = np.random.default_rng(9).random(len(pts)) < 0.95
    got = pointcloud.voxel_downsample(torch.as_tensor(pts), 0.01, torch.as_tensor(valid),
                                      num_buckets=num_buckets)
    want = jpc.voxel_downsample(jnp.asarray(pts), 0.01, jnp.asarray(valid),
                                num_buckets=num_buckets)
    _assert_voxels_close(got, want)


def test_voxel_key_wraps_like_int32():
    """The pin for the int32 wrap: at 1000 buckets the wrapped key differs
    from the true int64 sum's for some voxels, and the port's key is the
    wrapped one."""
    cell = np.random.default_rng(10).integers(0, 120, (2000, 3))
    primes = np.array([73856093, 19349663, 83492791], np.int64)
    s = (cell * primes).sum(1)
    wrapped = ((s + 2**31) % 2**32 - 2**31) % 1000
    assert (wrapped != s % 1000).any()
    got = pointcloud.voxel_key(torch.as_tensor(cell), 1000).numpy()
    np.testing.assert_array_equal(got, wrapped)


@pytest.mark.parametrize("with_valid", [False, True])
def test_ransac_scoring_with_jax_indices(with_valid):
    """The port's scorer on the hypotheses jax.random drew inside JAX's
    ransac_plane: the same plane and the same inliers."""
    pts = _cloud(seed=11, n=600)
    n = len(pts)
    valid = np.random.default_rng(12).random(n) < 0.9 if with_valid else np.ones(n, bool)
    idx = np.array(jax.random.randint(jax.random.PRNGKey(3), (100, 3), 0, n))
    got = pointcloud._score_planes(torch.as_tensor(pts), torch.as_tensor(valid),
                                   torch.as_tensor(idx), 0.02)
    want = jpc.ransac_plane(jnp.asarray(pts), jnp.asarray(valid), threshold=0.02, iters=100,
                            seed=3)
    np.testing.assert_allclose(got.coeffs.numpy(), np.asarray(want.coeffs), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(want.inliers))
    assert int(got.num_inliers) == int(want.num_inliers)


def test_seeded_ransac_plane_and_removal():
    """tests/test_dbscan.py's plane scene through the port's draw at the
    default seed: the plane is found, the blob kept, the normal vertical."""
    rng = np.random.default_rng(5)
    plane_pts = np.stack([rng.uniform(0, 1, 500), rng.uniform(0, 1, 500),
                          np.full(500, 0.3) + rng.normal(0, 0.005, 500)], 1)
    blob = rng.normal((0.5, 0.5, 0.8), 0.05, (100, 3))
    pts = torch.as_tensor(np.concatenate([plane_pts, blob]).astype(np.float32))
    res = pointcloud.ransac_plane(pts, threshold=0.02, iters=100)
    inl = res.inliers.numpy()
    assert inl[:500].mean() > 0.95
    assert inl[500:].mean() < 0.2
    keep = pointcloud.remove_plane(pts, torch.ones(len(pts), dtype=torch.bool), res).numpy()
    assert keep[500:].mean() > 0.8
    assert abs(abs(float(res.coeffs[2])) - 1.0) < 0.05
    again = pointcloud.ransac_plane(pts, threshold=0.02, iters=100)
    assert torch.equal(again.coeffs, res.coeffs) and torch.equal(again.inliers, res.inliers)
