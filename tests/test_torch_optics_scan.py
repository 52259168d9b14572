"""App B per slice (`pipeline.optics_scan`, `optics.optics_slice`) on the
CPU: 2048-event slices of seeded textured streams at 1280x720
(`io/synthetic.py`), which take the dense table as the benchmark's slices
do, with a short last slice.

- Each slice's order, reach and membership equal `compute_reachability_dists`
  plus `get_cluster_indices` on its valid pixels, and its sizes, centroids
  and variances are its clusters' own (float64 NumPy within float32's
  rounding).
- The plain reference of the benchmark (`perfbench/reference/optics.py`,
  an ordered set with decrease-key, no heap) gives the same order, reach,
  membership, count and sizes, and centroids and standard deviations within
  1e-3 px; on the committed fixture it prints the golden report.
- K is exact: a slice whose largest neighbourhood passes max_neighbors
  (hundreds of events on one pixel) is built once at a wider K, exact and
  with no warning; one past the table's cap raises; a truncated table is
  refused.
- Invalid lanes take no part; a slice with fewer than min_pts valid points,
  or none, clusters what it has.
- The spans: one `slice`, `optics`, `optics.table`, `optics.sweep` and
  `optics.extract` per slice.
"""

import json
import os
import warnings

import numpy as np
import pytest
import torch

from evflow_tpu_torch import native
from evflow_tpu_torch.config import DEFAULT, OpticsConfig
from evflow_tpu_torch.io import load_csv, synthetic
from evflow_tpu_torch.io.slicing import slice_by_count
from evflow_tpu_torch.models import optics, pipeline
from perfbench.reference import optics as ref_optics

torch.set_num_threads(2)


@pytest.fixture(scope="module", autouse=True)
def accurate_sqrt():
    """The CPU build's first large float32 sqrt in a process can run some of
    its threads at reduced accuracy (about 2^-12 relative); one large sqrt
    first keeps every compared run on the accurate path."""
    torch.sqrt(torch.rand(2048, 16384))


N = 2048
CFG = OpticsConfig(min_pts=2, epsilon=10.0)
ECFG = DEFAULT.replace(optics=CFG)
THRESHOLD = 10.0
REF_CFG = {"optics": {"min_pts": 2, "epsilon": 10.0}, "extraction": {"threshold": THRESHOLD}}
SEEDS = [3, 4, 5]
FIXTURE = os.path.join(os.path.dirname(__file__), "data", "event_raw_data8.csv")
GOLDEN = os.path.join(os.path.dirname(__file__), "data", "golden_optics_data8.txt")


def _slices(seed, num_slices=2, tail=1700, num_objects=4):
    """(S, N) x, y, valid of a textured stream of num_slices full slices and a
    last one of `tail` events."""
    st = synthetic.textured_field_stream(num_slices=num_slices + 1, events_per_slice=N,
                                         num_objects=num_objects, seed=seed)
    st = type(st)(*(a[:num_slices * N + tail] for a in (st.x, st.y, st.t, st.p)))
    sl = slice_by_count(st, N)
    return tuple(torch.as_tensor(a) for a in (sl.x, sl.y, sl.valid_mask()))


def _scan(xs, ys, vs, cfg=ECFG):
    return pipeline.optics_scan(torch.zeros((), dtype=torch.int32), xs, ys, None, vs, cfg,
                                THRESHOLD)


@pytest.fixture(scope="module", params=SEEDS)
def scanned(request):
    xs, ys, vs = _slices(request.param)
    state, out = _scan(xs, ys, vs)
    return (xs, ys, vs), state, out


def _whole_cloud(x, y, v):
    """compute_reachability_dists + get_cluster_indices on the valid pixels,
    in lane numbers: (order, reach in order, clusters as lists of lanes)."""
    lanes = np.flatnonzero(v.numpy())
    pts = np.stack([x.numpy(), y.numpy()], 1)[lanes].astype(np.float64)
    rd = optics.compute_reachability_dists(pts, CFG.min_pts, CFG.epsilon, device="cpu")
    order = lanes[[r.point_index for r in rd]]
    reach = np.array([r.reach_dist for r in rd])
    clusters = [lanes[c] for c in optics.get_cluster_indices(rd, THRESHOLD)]
    return order, reach, clusters


def _check_against_whole_cloud(out, s, x, y, v):
    order, reach, clusters = _whole_cloud(x, y, v)
    nv = len(order)
    got_order = out.order[s].numpy()
    np.testing.assert_array_equal(got_order[:nv], order)
    assert (got_order[nv:] == -1).all()
    np.testing.assert_array_equal(out.reach[s].numpy()[order], reach.astype(np.float32))
    assert (out.reach[s].numpy()[~v.numpy()] == -1).all()
    k = int(out.num_clusters[s])
    assert k == len(clusters)
    cluster = out.cluster[s].numpy()
    assert (cluster[~v.numpy()] == -1).all()
    xy = np.stack([x.numpy(), y.numpy()], 1).astype(np.float64)
    for j, c in enumerate(clusters):
        assert (cluster[c] == j).all()
        assert int(out.size[s, j]) == len(c)
        np.testing.assert_allclose(out.centroid[s, j].numpy(), xy[c].mean(0), rtol=1e-6)
        np.testing.assert_allclose(out.variance[s, j].numpy(), xy[c].var(0), rtol=1e-4,
                                   atol=1e-4)
    assert (out.size[s, k:] == 0).all() and (out.centroid[s, k:] == 0).all()
    return k


def test_each_slice_is_compute_reachability_dists(scanned):
    (xs, ys, vs), state, out = scanned
    assert int(state) == xs.shape[0]
    for s in range(xs.shape[0]):
        assert _check_against_whole_cloud(out, s, xs[s], ys[s], vs[s]) > 100


def test_the_reference_agrees(scanned):
    (xs, ys, vs), _, out = scanned
    for s in range(xs.shape[0]):
        ref = ref_optics.cluster_slice(xs[s], ys[s], vs[s], REF_CFG)
        for f in ("order", "reach", "cluster", "size"):
            np.testing.assert_array_equal(getattr(out, f)[s].numpy(), ref[f], err_msg=f)
        assert int(out.num_clusters[s]) == int(ref["num_clusters"])
        np.testing.assert_allclose(out.centroid[s].numpy(), ref["centroid"], rtol=0, atol=1e-3)
        np.testing.assert_allclose(np.sqrt(out.variance[s].numpy()), np.sqrt(ref["variance"]),
                                   rtol=0, atol=1e-3)


def test_the_reference_prints_the_golden_report():
    """App B's report of the committed fixture (min_pts 2, eps 10, threshold
    10) from the reference's float32 clusters, within the printed digits."""
    s = load_csv(FIXTURE)
    x, y = torch.as_tensor(s.x), torch.as_tensor(s.y)
    ref = ref_optics.cluster_slice(x, y, torch.ones(len(x), dtype=torch.bool), REF_CFG)
    lines = open(GOLDEN).read().splitlines()
    k = int(ref["num_clusters"])
    assert lines[0] == f"Cluster size : {k}" and len(lines) == k + 1
    for j, line in enumerate(lines[1:]):
        want = [float(v) for v in line.split(",")]
        got = [j, ref["size"][j], *ref["centroid"][j], *ref["variance"][j]]
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)


def test_wide_neighbourhood_is_exact_without_a_warning(monkeypatch):
    """300 events on one pixel: the largest neighbourhood passes
    max_neighbors (256), so the table is built once, 512 wide, and the slice
    equals the whole-cloud path (which builds twice, warning)."""
    xs, ys, vs = _slices(7, num_slices=1, tail=N)
    xs, ys = xs.clone(), ys.clone()
    xs[0, 100:400], ys[0, 100:400] = 640, 360
    widths = []
    build = optics.build_table

    def counted(pts, eps, min_pts, max_neighbors, *a, **kw):
        widths.append(max_neighbors)
        return build(pts, eps, min_pts, max_neighbors, *a, **kw)

    monkeypatch.setattr(optics, "build_table", counted)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        _, out = _scan(xs[:1], ys[:1], vs[:1])
    assert widths == [512]
    monkeypatch.setattr(optics, "build_table", build)
    with pytest.warns(RuntimeWarning, match="recomputing"):
        _check_against_whole_cloud(out, 0, xs[0], ys[0], vs[0])


def test_a_neighbourhood_past_the_cap_raises():
    """1,100 events on one pixel: K would pass the (N, K) cap of 1,024."""
    xs, ys, vs = _slices(7, num_slices=1, tail=N)
    xs, ys = xs.clone(), ys.clone()
    xs[0, :1100], ys[0, :1100] = 10, 10
    with pytest.raises(RuntimeError, match="cap"):
        _scan(xs[:1], ys[:1], vs[:1])


def test_a_truncated_table_is_refused(monkeypatch):
    """A table narrower than its largest count is never swept."""
    build = optics.build_table

    def truncated(*a, **kw):
        t = build(*a, **kw)
        return optics.NeighborTable(t.idx[:, :8], t.dist[:, :8], t.count, t.core_dist)

    monkeypatch.setattr(optics, "build_table", truncated)
    xs, ys, vs = _slices(8, num_slices=1, tail=N)
    with pytest.raises(RuntimeError, match="holds a neighborhood"):
        _scan(xs[:1], ys[:1], vs[:1])


@pytest.mark.parametrize("seed", SEEDS[:2])
def test_invalid_lanes_take_no_part(seed):
    """Lanes marked invalid, in a block and scattered, change nothing of the
    valid ones' clustering and come out as -1."""
    xs, ys, vs = _slices(seed, num_slices=1, tail=N)
    rng = np.random.default_rng(seed)
    v = vs[0].clone()
    v[300:700] = False
    v[torch.as_tensor(rng.random(N) < 0.2)] = False
    _, out = _scan(xs[:1], ys[:1], v[None])
    _check_against_whole_cloud(out, 0, xs[0], ys[0], v)
    assert (out.order[0] >= 0).sum() == v.sum()


@pytest.mark.parametrize("valid_points", [0, 1])
def test_fewer_points_than_min_pts(valid_points):
    """Below min_pts nothing is core: each valid point is its own cluster,
    unreached; with none, no cluster."""
    xs, ys, vs = _slices(3, num_slices=1, tail=N)
    v = torch.zeros(N, dtype=torch.bool)
    v[17:17 + valid_points] = True
    _, out = _scan(xs[:1], ys[:1], v[None])
    assert int(out.num_clusters[0]) == valid_points
    assert out.order[0].tolist() == list(range(17, 17 + valid_points)) + [-1] * (N - valid_points)
    assert (out.reach[0] == -1).all()
    assert out.size[0].sum() == valid_points
    if valid_points:
        assert int(out.cluster[0, 17]) == 0
        assert out.centroid[0, 0].tolist() == [float(xs[0, 17]), float(ys[0, 17])]
        assert out.variance[0, 0].tolist() == [0.0, 0.0]


@pytest.mark.parametrize("seed", [0, 1])
def test_two_pass_variance_at_1200_px(seed):
    """Clusters of points spread near (1,200, 700) px: the float32 two-pass
    variances hold float64 NumPy's to 1e-4 relative, where E[x^2] - E[x]^2
    in float32 would cancel (x^2 ~ 1.4e6, whose float32 step is 0.125 px^2,
    against variances of ~16 px^2)."""
    rng = np.random.default_rng(seed)
    n = 600
    x = np.clip(np.round(rng.normal(1200, 4.0, n)), 0, 1279).astype(np.int64)
    y = np.clip(np.round(rng.normal(700, 4.0, n)), 0, 719).astype(np.int64)
    xs, ys = torch.as_tensor(x)[None], torch.as_tensor(y)[None]
    _, out = _scan(xs, ys, torch.ones((1, n), dtype=torch.bool))
    k = int(out.num_clusters[0])
    cl = out.cluster[0].numpy()
    big = [j for j in range(k) if out.size[0, j] > 100]
    assert big
    for j in big:
        want = np.stack([x[cl == j], y[cl == j]], 1).astype(np.float64).var(0)
        assert want.min() > 4.0
        np.testing.assert_allclose(out.variance[0, j].numpy(), want, rtol=1e-4)


def test_cellpair_slice_agrees():
    """A sparse slice at 640x400 takes the cell-pair table (the benchmark's
    take the dense one): the same order, reach and membership."""
    st = synthetic.textured_field_stream(num_slices=1, events_per_slice=512, num_objects=3,
                                         seed=9, width=640, height=400)
    x, y = torch.as_tensor(st.x), torch.as_tensor(st.y)
    pts = torch.stack([x, y], 1).to(torch.float32)
    assert optics.cellpair_neighbors(pts, 10.0, 2) is not None
    v = torch.ones(len(x), dtype=torch.bool)
    _, out = _scan(x[None], y[None], v[None])
    _check_against_whole_cloud(out, 0, x, y, v)


def test_estimated_epsilon_is_the_whole_cloud_s():
    """cfg.epsilon <= 0 estimates eps from the valid points, as
    compute_reachability_dists does."""
    xs, ys, vs = _slices(4, num_slices=1, tail=N)
    v = vs[0].clone()
    v[:1850] = False
    _, out = _scan(xs[:1], ys[:1], v[None], DEFAULT.replace(optics=OpticsConfig(min_pts=3)))
    lanes = np.flatnonzero(v.numpy())
    pts = np.stack([xs[0].numpy(), ys[0].numpy()], 1)[lanes].astype(np.float64)
    rd = optics.compute_reachability_dists(pts, 3, -1.0, device="cpu")
    np.testing.assert_array_equal(out.order[0].numpy()[:len(lanes)],
                                  lanes[[r.point_index for r in rd]])


def test_float32_sweep_equals_float64():
    """The native sweep reads a float32 table as it is: the order and the
    reach's values of the widened float64 table."""
    rng = np.random.default_rng(0)
    n, k = 400, 24
    idx = np.stack([rng.permutation(n)[:k] for _ in range(n)]).astype(np.int32)
    dist = np.sqrt(rng.integers(0, 60, (n, k))).astype(np.float32)
    pad = rng.random((n, k)) < 0.3
    idx[pad], dist[pad] = -1, np.inf
    core = np.sqrt(rng.integers(0, 30, n)).astype(np.float32)
    core[rng.random(n) < 0.2] = np.inf
    o32, r32 = native.optics_sweep(idx, dist, core)
    o64, r64 = native.optics_sweep(idx, dist.astype(np.float64), core.astype(np.float64))
    assert r32.dtype == np.float32 and r64.dtype == np.float64
    np.testing.assert_array_equal(o32, o64)
    np.testing.assert_array_equal(r32.astype(np.float64), r64)


def test_spans_one_of_each_per_slice(tmp_path):
    xs, ys, vs = _slices(3)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _scan(xs, ys, vs)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
             for e in events if e.get("cat") == "user_annotation" and e.get("ph") == "X"]
    names = ("slice", "optics", "optics.table", "optics.sweep", "optics.extract")
    assert {n: sum(s[0] == n for s in spans) for n in names} == {n: xs.shape[0] for n in names}
    slices = [(a, b) for n, a, b in spans if n == "slice"]
    assert all(any(a <= s and e <= b for a, b in slices) for n, s, e in spans if n != "slice")
