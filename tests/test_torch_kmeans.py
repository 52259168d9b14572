"""The port's k-means (app D) and the ops under it, `ops/segment.py` and
`ops/distance.py`, against the JAX package on the same numpy inputs.

Tolerances: integer results (counts, labels, ranks, neighbor counts,
`iters`) equal. Segment sums bit-equal (the same stream order of adds).
Difference-form distances within rtol 1e-6 / atol 1e-5. The panel form
|a|^2 + |b|^2 - 2ab on float coordinates within rtol 1e-5 / atol 1e-2 on
d^2 and atol 5e-3 on d (its cancellation error, summed in another order
than XLA's dot); on integer pixel coordinates every term is exact, so d^2
is bit-equal and d within one ulp (JAX's sqrt on the CPU). k-means
centroids within 1e-4; labels equal except where a point's two nearest
centroids are within 1e-3 of each other."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from evflow_tpu.config import KMeansConfig
from evflow_tpu.io import synthetic
from evflow_tpu.models import kmeans as jkm
from evflow_tpu.ops import distance as jdist, segment as jseg
from evflow_tpu_torch.models import kmeans
from evflow_tpu_torch.ops import distance, segment

torch.set_num_threads(2)

FLOAT_TOL = dict(rtol=1e-6, atol=1e-5)


def _t(*arrays):
    return [torch.as_tensor(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _same(got, want, **tol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (got.dtype, want.dtype)
    if tol:
        np.testing.assert_allclose(got, want, **tol)
    else:
        np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------------ segment

def _segment_case(kind, n=300, k=7, d=2, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, k, n).astype(np.int32)
    ids[:5] = [-1, k, k + 3, -2, 0]          # out of range: dropped (or wrapped by .at)
    valid = rng.random(n) < 0.8
    if kind == "pixels":
        pts = rng.integers(0, 1280, (n, d)).astype(np.float32)
    else:
        pts = rng.normal(0, 100, (n, d)).astype(np.float32)
    return pts, ids, valid, k


def test_segment_mean_and_compaction_example():
    """tests/test_ops.py's example, through the port and JAX."""
    pts = np.array([[1.0, 1], [2, 2], [3, 3], [10, 10]], np.float32)
    ids = np.array([0, 0, 1, 1], np.int32)
    valid = np.array([True, True, True, False])
    mean, counts = segment.segment_mean_points(*_t(pts, ids), 3, torch.as_tensor(valid))
    np.testing.assert_allclose(mean.numpy(), [[1.5, 1.5], [3, 3], [0, 0]])
    np.testing.assert_array_equal(counts.numpy(), [2, 1, 0])
    for fn in (segment.compact_by_segment, segment.compact_by_segment_sorted):
        dense, cnt = fn(*_t(pts, ids), 3, torch.as_tensor(valid), capacity=4)
        assert dense.shape == (3, 4, 2)
        np.testing.assert_allclose(dense[0, :2].numpy(), [[1, 1], [2, 2]])
        np.testing.assert_allclose(dense[1, 0].numpy(), [3, 3])
        np.testing.assert_array_equal(cnt.numpy(), [2, 1, 0])


@pytest.mark.parametrize("kind", ["float", "pixels"])
def test_segment_sums_match_jax(kind):
    """masked_segment_sum (1-D and 2-D values), segment_counts and
    segment_mean_points; on pixel coordinates and on floats alike the
    stream-order run sums give JAX's bits."""
    pts, ids, valid, k = _segment_case(kind)
    tp, ti, tv = _t(pts, ids, valid)
    jp_, ji, jv = _j(pts, ids, valid)
    _same(segment.masked_segment_sum(tp, ti, k, tv), jseg.masked_segment_sum(jp_, ji, k, jv))
    _same(segment.masked_segment_sum(tp[:, 0].contiguous(), ti, k, tv),
          jseg.masked_segment_sum(jp_[:, 0], ji, k, jv))
    _same(segment.segment_counts(ti, k, tv), jseg.segment_counts(ji, k, jv))
    ints = ids.astype(np.int32) * 3
    _same(segment.masked_segment_sum(torch.as_tensor(ints), ti, k, tv),
          jseg.masked_segment_sum(jnp.asarray(ints), ji, k, jv))
    for g, w in zip(segment.segment_mean_points(tp, ti, k, tv),
                    jseg.segment_mean_points(jp_, ji, k, jv)):
        _same(g, w)


@pytest.mark.parametrize("fill", [1e9, -5.0])
def test_scatter_min_max_match_jax(fill):
    pts, ids, _, k = _segment_case("float", seed=1)
    v = pts[:, 0].copy()
    _same(segment.scatter_min(*_t(v, ids), k, fill), jseg.scatter_min(*_j(v, ids), k, fill))
    _same(segment.scatter_max(*_t(v, ids), k, fill), jseg.scatter_max(*_j(v, ids), k, fill))


@pytest.mark.parametrize("capacity", [3, 64])
@pytest.mark.parametrize("fn", ["compact_by_segment", "compact_by_segment_sorted"])
def test_compaction_matches_jax(fn, capacity):
    """Per-segment stream-ordered rows, capacity overflow dropped."""
    pts, ids, valid, k = _segment_case("float", n=200, seed=2)
    got = getattr(segment, fn)(*_t(pts, ids), k, torch.as_tensor(valid), capacity=capacity)
    want = getattr(jseg, fn)(*_j(pts, ids), k, jnp.asarray(valid), capacity=capacity)
    for g, w in zip(got, want):
        _same(g, w)


# ------------------------------------------------------------------ distance

def _points(kind, n, d=2, seed=3):
    rng = np.random.default_rng(seed)
    if kind == "pixels":
        return rng.integers(0, 1280, (n, d)).astype(np.float32)
    return rng.uniform(0, 100, (n, d)).astype(np.float32)


def test_pairwise_and_assign_examples():
    """tests/test_ops.py's examples."""
    a = np.array([[0.0, 0.0], [3.0, 4.0]], np.float32)
    b = np.array([[0.0, 0.0], [6.0, 8.0]], np.float32)
    np.testing.assert_allclose(distance.pairwise_sqdist(*_t(a, b)).numpy(),
                               [[0, 100], [25, 25]], atol=1e-4)
    np.testing.assert_allclose(distance.pairwise_manhattan(*_t(a, b)).numpy(),
                               [[0, 14], [7, 7]], atol=1e-5)
    pts = np.array([[0.0, 0.0], [100.0, 100.0], [10.0, 0.0]], np.float32)
    centers = np.array([[0.0, 0.0], [20.0, 0.0]], np.float32)
    res = distance.assign_to_centers(*_t(pts, centers), threshold=50.0)
    np.testing.assert_array_equal(res.labels.numpy(), [0, -1, 0])      # tie: first
    pts = np.array([[0.0, 0], [1, 0], [2, 0], [50, 50]], np.float32)
    np.testing.assert_array_equal(
        distance.radius_neighbor_counts(torch.as_tensor(pts), eps=1.5).numpy(), [2, 3, 2, 1])
    np.testing.assert_allclose(distance.kth_neighbor_dist(torch.as_tensor(pts), k=2).numpy(),
                               [1.0, 1.0, 1.0, np.hypot(48, 50)], rtol=1e-5)


@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("kind", ["float", "pixels"])
def test_distances_match_jax(kind, d):
    a, b = _points(kind, 300, d), _points(kind, 40, d, seed=4)
    tol = {} if kind == "pixels" else FLOAT_TOL
    if kind == "pixels":        # exact: JAX's bits
        _same(distance.pairwise_sqdist(*_t(a, b)), jdist.pairwise_sqdist(*_j(a, b)))
    else:                       # |a|^2 + |b|^2 - 2ab cancels: absolute scale |a|^2 eps
        _same(distance.pairwise_sqdist(*_t(a, b)), jdist.pairwise_sqdist(*_j(a, b)),
              rtol=1e-5, atol=1e-2)
    _same(distance.pairwise_manhattan(*_t(a, b)), jdist.pairwise_manhattan(*_j(a, b)), **tol)
    got = distance.assign_to_centers(*_t(a, b), threshold=60.0)
    want = jdist.assign_to_centers(*_j(a, b), threshold=60.0)
    _same(got.labels, want.labels)
    _same(got.dists, want.dists, **tol)


@pytest.mark.parametrize("kind", ["float", "pixels"])
def test_radius_counts_and_kth_match_jax(kind):
    """Tiled by `block` (a ragged last block), with a validity mask."""
    pts = _points(kind, 500, seed=5) / (1 if kind == "float" else 8)
    valid = np.random.default_rng(6).random(500) < 0.9
    eps = 9.0
    if kind == "float":          # no pair within 1e-4 of eps: counts are exact
        d = np.sqrt(((pts[:, None].astype(np.float64) - pts[None]) ** 2).sum(-1))
        assert np.abs(d - eps).min() > 1e-4
    _same(distance.radius_neighbor_counts(torch.as_tensor(pts), eps, torch.as_tensor(valid),
                                          block=128),
          jdist.radius_neighbor_counts(jnp.asarray(pts), eps, jnp.asarray(valid), block=128))
    # pixels: the squared distances are exact, but JAX's sqrt on the CPU
    # is not always correctly rounded (one ulp); floats: the panel form's
    # cancellation error, |a|^2 * 2^-23 on d^2, over 2d
    tol = dict(rtol=2.5e-7, atol=0) if kind == "pixels" else dict(rtol=0, atol=5e-3)
    for eps_k in (None, eps):
        _same(distance.kth_neighbor_dist(torch.as_tensor(pts), 4, eps_k, block=128),
              jdist.kth_neighbor_dist(jnp.asarray(pts), 4, eps_k, block=128), **tol)


@pytest.mark.parametrize("d", [1, 2, 3, 6])
def test_pairwise_sqdist_rounds_in_a_fixed_order(d):
    """Every rounding of pairwise_sqdist in a fixed order, the one
    csrc/dbscan_eps.cu repeats: squared norms and the cross term summed
    term by term from the first coordinate, then (a2 + b2) - 2 cross,
    clamped at 0; the same bits as numpy's float32 steps."""
    a, b = _points("float", 200, d, seed=7), _points("float", 50, d, seed=8)

    def norm(p):
        s = p[:, 0] * p[:, 0]
        for k in range(1, d):
            s = s + p[:, k] * p[:, k]
        return s

    cross = a[:, None, 0] * b[None, :, 0]
    for k in range(1, d):
        cross = cross + a[:, None, k] * b[None, :, k]
    want = np.maximum((norm(a)[:, None] + norm(b)[None, :]) - np.float32(2) * cross,
                      np.float32(0))
    assert want.dtype == np.float32
    np.testing.assert_array_equal(distance.pairwise_sqdist(*_t(a, b)).numpy(), want)


def test_pairwise_sqdist_large_coordinate_precision():
    """Coordinates around 1e3 with a 5.64 gate under float32 matmul
    precision "high" (which allows TF32 in matmuls): the neighbor test
    equals the float64 oracle's, as tests/test_ops.py asks of JAX."""
    rng = np.random.default_rng(5)
    pts = rng.uniform(0, 1000, (2048, 2)).astype(np.float32)
    oracle = ((pts[:, None, :].astype(np.float64) - pts[None, :, :]) ** 2).sum(-1)
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        d2 = distance.pairwise_sqdist(*_t(pts, pts)).numpy()
    finally:
        torch.set_float32_matmul_precision(prev)
    np.testing.assert_array_equal(d2 <= 5.64 ** 2, oracle <= 5.64 ** 2)


# ------------------------------------------------------------------ k-means

def _kmeans_cases():
    rng = np.random.default_rng(0)
    centers = np.array([[100.0, 100], [400, 120], [250, 300]], np.float32)
    blobs = np.concatenate([c + rng.normal(0, 5, size=(300, 2))
                            for c in centers]).astype(np.float32)
    blob_init = (centers + rng.normal(0, 10, size=centers.shape)).astype(np.float32)
    return {
        "ramp": (synthetic.kmeans_ramp_data(2048), synthetic.kmeans_initial_centroids(),
                 None, KMeansConfig()),
        "gate": (np.array([[0.0, 0], [1, 1], [500, 500]], np.float32),
                 np.array([[0.0, 0]], np.float32), None, KMeansConfig(k=1)),
        "blobs": (blobs, blob_init, None, KMeansConfig(convergence_tol=0.1, max_iters=50)),
        "valid-mask": (np.array([[0.0, 0], [1, 1], [30, 30], [31, 31]], np.float32),
                       np.array([[0.0, 0], [30.0, 30.0]], np.float32),
                       np.array([True, True, False, False]),
                       KMeansConfig(convergence_tol=0.01)),
    }


def _assert_kmeans_close(got, want, pts):
    c = np.asarray(want.centroids)
    np.testing.assert_allclose(got.centroids.numpy(), c, atol=1e-4)
    _same(got.counts, want.counts)
    _same(got.iters, want.iters)
    _same(got.error_max, want.error_max, atol=1e-4)
    gl, wl = got.labels.numpy(), np.asarray(want.labels)
    diff = gl != wl
    if diff.any():
        d = np.sort(np.linalg.norm(pts[:, None, :] - c[None], axis=2), axis=1)
        assert (d[diff, 1] - d[diff, 0] < 1e-3).all()


@pytest.mark.parametrize("case", list(_kmeans_cases()))
def test_kmeans_matches_jax(case):
    pts, init, valid, cfg = _kmeans_cases()[case]
    got = kmeans.kmeans(*_t(pts, init), None if valid is None else torch.as_tensor(valid),
                        cfg=cfg)
    want = jkm.kmeans(*_j(pts, init), None if valid is None else jnp.asarray(valid), cfg=cfg)
    _assert_kmeans_close(got, want, pts)
    _same(kmeans.compat_labels(got.labels), jkm.compat_labels(want.labels))
    assert int(got.iters) >= 1
    if case == "gate":
        np.testing.assert_array_equal(kmeans.compat_labels(got.labels).numpy(), [0, 0, 255])
    if case == "valid-mask":
        np.testing.assert_array_equal(got.labels[2:].numpy(), [-1, -1])
        np.testing.assert_allclose(got.centroids[1].numpy(), [30, 30], atol=1e-3)


@pytest.mark.parametrize("max_iters", [0, 1, 3])
def test_kmeans_iteration_cap(max_iters):
    """The loop stops at max_iters with JAX's iters and error_max (inf when
    no iteration ran)."""
    pts, init = synthetic.kmeans_ramp_data(512), synthetic.kmeans_initial_centroids()
    cfg = KMeansConfig(max_iters=max_iters, convergence_tol=0.0)
    got = kmeans.kmeans(*_t(pts, init), cfg=cfg)
    want = jkm.kmeans(*_j(pts, init), cfg=cfg)
    _assert_kmeans_close(got, want, pts)
    assert int(got.iters) == max_iters
