"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked `cuda` and skips without a CUDA device. The file
imports no JAX, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

(`--noconftest`: the suite's conftest configures JAX).
"""

import dataclasses

import numpy as np
import pytest
import torch

from evflow_tpu_torch import interop, kernels
from evflow_tpu_torch.config import (DEFAULT, ClusterConfig, EFastConfig, NMSConfig,
                                     SensorConfig, SliceConfig, TrackerConfig)
from evflow_tpu_torch.io import slice_by_count, synthetic
from evflow_tpu_torch.models import aeclustering as ae, aeclustering_kernel as aek
from evflow_tpu_torch.models import dbscan, fastcluster, pipeline
from evflow_tpu_torch.ops import cluster_kernels as ck, distance, efast

from test_torch_streams import STREAMS, drifting_blobs

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _surface(rng, h, w):
    sae = np.zeros((h, w), np.int32)
    for ax, ay, t0 in ((40, 40, 100), (100, 80, 200), (700, 300, 300), (1000, 600, 400)):
        if ay < h and ax < w:
            sae[ay - 10:ay + 1, ax - 10:ax + 1] = rng.integers(t0, t0 + 50, (11, 11))
    nz = rng.random((h, w)) < 0.08
    sae[nz] = rng.integers(1, 90, nz.sum())
    return torch.as_tensor(sae)


def test_efast_stencil_matches_plain(cuda):
    rng = np.random.default_rng(9)
    sensor = SensorConfig()
    st = _surface(rng, 720, 1280).to(cuda)
    before = kernels.LAUNCHES["efast_stencil"]
    for cfg in (EFastConfig(), EFastConfig(group_track_axis_order=False)):
        for act in (torch.ones((30, 10), dtype=torch.bool),
                    torch.as_tensor(rng.random((30, 10)) < 0.4)):
            act = act.to(cuda)
            got = efast.corner_mask_stencil(st, act, cfg, sensor)
            assert torch.equal(got, efast.corner_mask_stencil_plain(st, act, cfg, sensor))
    assert int(got.sum()) > 0
    assert kernels.LAUNCHES["efast_stencil"] == before + 4
    # ragged edges: the last band and the last column tile are partial
    cut = SensorConfig(width=1200, height=700)
    act = torch.ones((30, 10), dtype=torch.bool, device=cuda)
    sub = st[:700, :1200].contiguous()
    assert torch.equal(efast.corner_mask_stencil(sub, act, EFastConfig(), cut),
                       efast.corner_mask_stencil_plain(sub, act, EFastConfig(), cut))


@pytest.mark.parametrize("which", ["all-ones", "one-tile"])
def test_efast_stencil_activity_maps(cuda, which):
    """The row-group CTAs on an all-ones map (every CTA computes) and on a
    map with one active tile (one tile's CTAs compute, the rest zero-fill
    with 16-byte stores)."""
    rng = np.random.default_rng(10)
    st = _surface(rng, 720, 1280).to(cuda)
    act = torch.zeros((30, 10), dtype=torch.bool)
    if which == "all-ones":
        act[:] = True
    else:
        act[1, 0] = True           # holds the wedge at (40, 40)
    act = act.to(cuda)
    before = kernels.LAUNCHES["efast_stencil"]
    got = efast.corner_mask_stencil(st, act, EFastConfig(), SensorConfig())
    want = efast.corner_mask_stencil_plain(st, act, EFastConfig(), SensorConfig())
    assert torch.equal(got, want)
    assert int(want.sum()) > 0
    assert kernels.LAUNCHES["efast_stencil"] == before + 1


@pytest.mark.parametrize("bounds", [(2, 9, 3, 12), (3, 6, 4, 8), (1, 15, 1, 19)])
@pytest.mark.parametrize("band", [24, 5])
def test_efast_stencil_bounds_and_bands(cuda, bounds, band):
    """Streak bounds other than the default ones (the kernel scans every
    length then) and a band of odd height (its last row group is one row)."""
    rng = np.random.default_rng(11)
    st = _surface(rng, 120, 256).to(cuda)
    cfg = EFastConfig(streak3_min=bounds[0], streak3_max=bounds[1],
                      streak4_min=bounds[2], streak4_max=bounds[3])
    sensor = SensorConfig(width=256, height=120)
    act = torch.as_tensor(rng.random((-(-120 // band), 2)) < 0.7).to(cuda)
    got = efast.corner_mask_stencil(st, act, cfg, sensor, band)
    assert torch.equal(got, efast.corner_mask_stencil_plain(st, act, cfg, sensor, band))


def _ring_lanes(rng, n, corners, h, w, border):
    """(x, y, valid) of n candidate lanes on an (h, w) surface: the surface's
    corners and edges and pixels either side of the border first, then
    corner pixels of the dense mask (`corners`, (K, 2) x, y) and random
    pixels in turn; 15 % of the lanes invalid."""
    fixed = [(0, 0), (w - 1, 0), (0, h - 1), (w - 1, h - 1), (w // 2, 0), (w // 2, h - 1),
             (0, h // 2), (w - 1, h // 2), (border, border), (border - 1, h // 2),
             (w - border - 1, h - border - 1), (w - border, border), (w // 2, h - border)]
    x = rng.integers(0, w, n)
    y = rng.integers(0, h, n)
    pick = rng.integers(0, len(corners), n)
    x[1::2], y[1::2] = corners[pick[1::2], 0], corners[pick[1::2], 1]
    k = min(n, len(fixed))
    x[:k], y[:k] = np.array(fixed[:k]).T
    v = rng.random(n) < 0.85
    return torch.as_tensor(x.astype(np.int32)), torch.as_tensor(y.astype(np.int32)), \
        torch.as_tensor(v)


@pytest.mark.parametrize("n", [1, 63, 64, 1024, 4097])
@pytest.mark.parametrize("axis_order", [True, False])
@pytest.mark.parametrize("bounds", [(3, 6, 4, 8), (2, 9, 3, 12)])
def test_efast_ring_matches_plain(cuda, n, axis_order, bounds):
    """The ring-test kernel against its plain version, bit for bit: lanes
    on the surface's edges and corners (the clamp), either side of the
    border and invalid; the surface's own sensor, a border of 0 (edge lanes
    are candidates, their rings clamped) and a slab sensor wider than the
    surface (parallel/tiling.py's case). One launch per call."""
    rng = np.random.default_rng(12 + n)
    h, w = 120, 256
    cfg = EFastConfig(streak3_min=bounds[0], streak3_max=bounds[1], streak4_min=bounds[2],
                      streak4_max=bounds[3], group_track_axis_order=axis_order)
    st = _surface(rng, h, w)
    own = SensorConfig(width=w, height=h)
    corners = efast.corner_mask_dense(st, cfg, own).nonzero().flip(1).numpy()
    assert len(corners) > 0
    x, y, v = _ring_lanes(rng, n, corners, h, w, cfg.border)
    args = [a[None].to(cuda) for a in (st, x, y, v)]
    total = 0
    for c, sensor in ((cfg, own), (dataclasses.replace(cfg, border=0), own),
                      (cfg, SensorConfig(width=w + 40, height=h))):
        before = kernels.LAUNCHES["efast_ring"]
        got = efast._ring_test(*args, c, sensor)
        assert kernels.LAUNCHES["efast_ring"] == before + 1
        want = efast._ring_test_plain(*[a[None] for a in (st, x, y, v)], c, sensor)
        assert torch.equal(got.cpu(), want), int((got.cpu() != want).sum())
        total += int(want.sum())
    if n >= 64:
        assert total > 0


def test_efast_ring_stack_and_empty(cuda):
    """detect_corners_stacked on the card (8 snapshots of 128 lanes, one
    launch) against the plain version; detect_corners at N = 0 launches
    nothing; the kernel path runs with synchronizing calls made errors."""
    rng = np.random.default_rng(21)
    h, w, q, m = 120, 256, 8, 128
    saes = torch.stack([_surface(rng, h, w) for _ in range(q)])
    sensor = SensorConfig(width=w, height=h)
    corners = efast.corner_mask_dense(saes[0], EFastConfig(), sensor).nonzero().flip(1).numpy()
    x, y, v = (torch.stack(a) for a in zip(*[_ring_lanes(rng, m, corners, h, w, 4)
                                              for _ in range(q)]))
    before = kernels.LAUNCHES["efast_ring"]
    got = efast.detect_corners_stacked(*[a.to(cuda) for a in (saes, x, y, v)],
                                       EFastConfig(), sensor)
    assert kernels.LAUNCHES["efast_ring"] == before + 1
    want = efast._ring_test_plain(saes, x, y, v, EFastConfig(), sensor)
    assert torch.equal(got.cpu(), want) and int(want.sum()) > 0
    sae, e = saes[0].to(cuda), torch.zeros(0, dtype=torch.int32, device=cuda)
    empty = efast.detect_corners(sae, e, e, e.bool(), EFastConfig(), sensor)
    assert empty.shape == (0,) and kernels.LAUNCHES["efast_ring"] == before + 1
    xc, yc, vc = x[0].to(cuda), y[0].to(cuda), v[0].to(cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        one = efast.detect_corners(sae, xc, yc, vc, EFastConfig(), sensor)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(one.cpu(), want[0])


@pytest.mark.parametrize("n", [16384, 1000, 1])
def test_cluster_kernels_match_plain(cuda, n):
    rng = np.random.default_rng(n)
    c = 128
    x = torch.as_tensor(rng.integers(0, 1280, n).astype(np.int32), device=cuda)
    y = torch.as_tensor(rng.integers(0, 720, n).astype(np.int32), device=cuda)
    mu = torch.as_tensor((rng.random((c, 2)) * 800).astype(np.float32), device=cuda)
    mu[5] = mu[3]                                    # tie: lowest index wins
    alive = torch.as_tensor(rng.random(c) > 0.4, device=cuda)
    lk, dk = ck.assign_manhattan(x, y, mu, alive, 40.0)
    lp, dp = ck.assign_manhattan_plain(x, y, mu, alive, 40.0)
    assert torch.equal(lk, lp) and torch.equal(dk, dp)

    labels = torch.as_tensor(rng.integers(-1, c, n).astype(np.int32), device=cuda)
    labels[torch.as_tensor(rng.random(n) < 0.3, device=cuda)] = 3
    xf, yf = x.to(torch.float32), y.to(torch.float32)
    sk = ck.cluster_stats(labels, xf, yf, 0.5, c)
    sp = ck.cluster_stats_plain(labels, xf, yf, 0.5, c)
    assert torch.equal(sk[:, :3], sp[:, :3])     # counts and integer sums exact
    torch.testing.assert_close(sk, sp, rtol=1e-5, atol=1e-3)


def _stats_inputs(n, c, kind, device):
    """Labels, x, y for cluster_stats. Coordinates stay below 200, and
    below 2^24 / N, so every sum x and sum y is exact in f32 (< 2^24)."""
    rng = np.random.default_rng(n + c)
    labels = rng.integers(-1, c, n).astype(np.int32)
    if kind == "none":
        labels[:] = -1
    elif kind == "one":
        labels[:] = c - 1          # exponents reach the clamp at 80
    hi = min(200, (1 << 24) // max(n, 1))
    x = rng.integers(0, hi, n).astype(np.float32)
    y = rng.integers(0, hi, n).astype(np.float32)
    return [torch.as_tensor(a, device=device) for a in (labels, x, y)]


def _stats_close(got, want):
    assert torch.equal(got[:, :3], want[:, :3])     # counts and integer sums exact
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("c", [1, 128, 4096])
@pytest.mark.parametrize("n", [0, 1, 7, 1000, 16384, 65536])
def test_cluster_stats_sizes(cuda, n, c):
    """The 8-CTA cluster at every size: a CTA range empty, ragged or not a
    multiple of 4 events, and C = 4096, whose per-cluster arrays leave room
    for chunks of 1168 events: N = 16384 and 65536 walk each CTA's range
    in 2 and 8 chunks."""
    labels, x, y = _stats_inputs(n, c, "random", cuda)
    before = kernels.LAUNCHES["cluster_stats"]
    got = ck.cluster_stats(labels, x, y, 0.3, c)
    _stats_close(got, ck.cluster_stats_plain(labels, x, y, 0.3, c))
    assert kernels.LAUNCHES["cluster_stats"] == before + 1


@pytest.mark.parametrize("kind,n", [("none", 16384), ("one", 16384), ("one", 65536),
                                    ("one", 1 << 18)])
def test_cluster_stats_edge_labels(cuda, kind, n):
    """Labels all -1, and one cluster holding every event (at N = 2^18 in
    three chunks per CTA, its ranks carried across them)."""
    c = 128
    labels, x, y = _stats_inputs(n, c, kind, cuda)
    got = ck.cluster_stats(labels, x, y, 0.1, c)
    _stats_close(got, ck.cluster_stats_plain(labels, x, y, 0.1, c))
    assert int(got[:, 0].sum()) == (0 if kind == "none" else n)


@pytest.mark.parametrize("n,c", [(16384, 128), (65536, 4096)])
def test_cluster_stats_deterministic(cuda, n, c):
    """No float atomics: two calls on the same input give the same bits,
    in one chunk per CTA and in several."""
    labels, x, y = _stats_inputs(n, c, "random", cuda)
    labels[: n // 2] = 5
    a = ck.cluster_stats(labels, x, y, 0.5, c)
    b = ck.cluster_stats(labels, x, y, 0.5, c)
    assert torch.equal(a, b)


def test_cluster_stats_limits(cuda):
    """C above MAX_CLUSTERS raises; N does not limit the kernel: 2^18
    events at C = 128 (three chunks per CTA) match the plain version."""
    z = torch.zeros(8, dtype=torch.int32, device=cuda)
    f = z.to(torch.float32)
    with pytest.raises(ValueError):
        ck.cluster_stats(z, f, f, 0.5, ck.MAX_CLUSTERS + 1)
    labels, x, y = _stats_inputs(1 << 18, 128, "random", cuda)
    _stats_close(ck.cluster_stats(labels, x, y, 0.5, 128),
                 ck.cluster_stats_plain(labels, x, y, 0.5, 128))


def test_launch_reads_current_stream(cuda):
    """A launch reads the stream handle through torch.accelerator: it is
    PyTorch's current stream, the default one or a side stream."""
    for st in (torch.cuda.current_stream(), torch.cuda.Stream()):
        with torch.cuda.stream(st):
            assert torch.accelerator.current_stream(torch.cuda.current_device()).native_handle \
                == st.cuda_stream
            labels, x, y = _stats_inputs(1000, 128, "random", cuda)
            got = ck.cluster_stats(labels, x, y, 0.5, 128)
        st.synchronize()
        _stats_close(got, ck.cluster_stats_plain(labels, x, y, 0.5, 128))


def _assign_case(kind, n, c, device):
    rng = np.random.default_rng(n + c)
    x = rng.integers(0, 1280, n).astype(np.int32)
    y = rng.integers(0, 720, n).astype(np.int32)
    mu = (rng.random((c, 2)) * 800).astype(np.float32)
    alive = rng.random(c) > 0.6
    if kind == "none":
        alive[:] = False
    elif kind == "last":
        alive[:] = False
        alive[c - 1] = True
        mu[c - 1] = np.round(mu[c - 1])
        x[: n // 2], y[: n // 2] = mu[c - 1]
    elif kind == "equal":
        lo, hi = 2, c - 2           # equal means at a lower and a higher index
        alive[[lo, hi]] = True
        mu[lo] = np.round(mu[lo])
        mu[hi] = mu[lo]
        x[: n // 2], y[: n // 2] = mu[lo]
    return [torch.as_tensor(a, device=device) for a in (x, y, mu, alive)]


@pytest.mark.parametrize("c", [128, 4096])
@pytest.mark.parametrize("n", [1, 1000, 1001, 16384])
@pytest.mark.parametrize("kind", ["random", "none", "last", "equal"])
def test_assign_manhattan_cases(cuda, kind, n, c):
    """Bit-equal to the plain version: no alive cluster, one alive at
    C - 1, equal means at a lower and a higher index, C = 4096 (48 KB of
    shared memory), and N not a multiple of the CTA's 64 events (odd N
    also takes the scalar path for the distances' row)."""
    x, y, mu, alive = _assign_case(kind, n, c, cuda)
    before = kernels.LAUNCHES["assign_manhattan"]
    lk, dk = ck.assign_manhattan(x, y, mu, alive, 40.0)
    lp, dp = ck.assign_manhattan_plain(x, y, mu, alive, 40.0)
    assert torch.equal(lk, lp) and torch.equal(dk, dp)
    assert kernels.LAUNCHES["assign_manhattan"] == before + 1
    if kind == "none":
        assert bool((lk == -1).all()) and bool(torch.isinf(dk).all())
    if kind == "last":
        assert bool((lk[: n // 2] == c - 1).all())
    if kind == "equal":
        assert bool((lk[: n // 2] == 2).all())


def test_full_scan_on_card_matches_cpu(cuda):
    n = 2048
    cfg = dataclasses.replace(
        DEFAULT, sensor=SensorConfig(width=256, height=120),
        slicing=SliceConfig(n_events=n),
        efast=dataclasses.replace(DEFAULT.efast, max_candidates=1024),
        nms=NMSConfig(max_corners=128), tracker=TrackerConfig(max_tracks=64),
        cluster=ClusterConfig(max_clusters=32))
    stream = synthetic.moving_blob_stream(
        num_slices=6, events_per_slice=n,
        blob_centers=((60.0, 50.0), (180.0, 70.0), (120.0, 30.0)),
        velocities=((4.0, 1.0), (-3.0, 2.0), (1.0, -1.0)), sigma=6.0,
        width=256, height=120)
    sl = slice_by_count(stream, n, drop_partial=True)
    arrays = (sl.x, sl.y, (sl.t - int(stream.t[0])).astype(np.int32), sl.valid_mask())

    def scan(device):
        cl = fastcluster.init_state(cfg.cluster, device=device)
        co = pipeline.init_corner_state(cfg, device=device)
        return pipeline.full_scan(cl, co, *[torch.as_tensor(a, device=device)
                                            for a in arrays], cfg)

    kernels.reset_launches()
    (gcl, gco), (gclo, gcoo) = scan(cuda)
    assert kernels.LAUNCHES == {"efast_stencil": 6, "efast_ring": 0, "assign_manhattan": 6,
                                "cluster_stats": 6, "aeclustering_exact": 0,
                                "dbscan_eps": 0, "rep_candidates": 6}, kernels.LAUNCHES
    (wcl, wco), (wclo, wcoo) = scan("cpu")
    interop.assert_trees_close((gcl, gclo), (wcl, wclo), rtol=1e-5, atol=1e-3)
    interop.assert_trees_close((gco, gcoo), (wco, wcoo), rtol=1e-5, atol=1e-4)
    assert int(gcoo.num_corners.sum()) > 0


@pytest.mark.parametrize("name", list(STREAMS))
def test_exact_kernel_matches_plain(cuda, name):
    """The update_slice_pallas counterpart on the card against the plain
    update_slice on the CPU, every slice, every AEState field bit-equal."""
    make, cfg = STREAMS[name]
    ks, ps = ae.init_state(cfg, device=cuda), ae.init_state(cfg, device="cpu")
    before = kernels.LAUNCHES["aeclustering_exact"]
    slices = 0
    for s, arrays in enumerate(make()):
        ks = aek.update_slice_kernel(ks, *[torch.as_tensor(a, device=cuda) for a in arrays], cfg)
        ps = ae.update_slice(ps, *[torch.as_tensor(a) for a in arrays], cfg)
        torch.cuda.synchronize()
        interop.assert_trees_close(ks, ps, rtol=0, atol=0, what=f"{name} slice {s}")
        slices += 1
    assert kernels.LAUNCHES["aeclustering_exact"] == before + slices


@pytest.mark.parametrize("alpha", [0.5, 0.8])
def test_exact_kernel_default_widths(cuda, alpha):
    """C = 128, M = 1024 (20.5 KB of dynamic shared memory), and C = 256,
    M = 4096 (57 KB: above the 48 KB default), on the drifting blobs."""
    for c, m in ((128, 1024), (256, 4096)):
        cfg = ClusterConfig(sz_buffer=800, radius=20.0, min_n=3, alpha=alpha,
                            max_clusters=c, max_members=m)
        ks, ps = ae.init_state(cfg, device=cuda), ae.init_state(cfg, device="cpu")
        for arrays in drifting_blobs(seed=1, n_slices=4, n=1500):
            ks = aek.update_slice_kernel(ks, *[torch.as_tensor(a, device=cuda)
                                               for a in arrays], cfg)
            ps = ae.update_slice(ps, *[torch.as_tensor(a) for a in arrays], cfg)
        interop.assert_trees_close(ks, ps, rtol=0, atol=0, what=f"C={c} M={m}")


def test_exact_kernel_at_max_members(cuda):
    """M = MAX_MEMBERS, the largest ring the kernel's shared memory holds,
    under a window longer than the ring: it fills, then overwrites."""
    cfg = ClusterConfig(sz_buffer=10000, radius=20.0, min_n=3, max_clusters=128,
                        max_members=aek.MAX_MEMBERS)
    ks, ps = ae.init_state(cfg, device=cuda), ae.init_state(cfg, device="cpu")
    for s, arrays in enumerate(drifting_blobs(seed=2, n_slices=3, n=3000)):
        ks = aek.update_slice_kernel(ks, *[torch.as_tensor(a, device=cuda) for a in arrays], cfg)
        ps = ae.update_slice(ps, *[torch.as_tensor(a) for a in arrays], cfg)
        torch.cuda.synchronize()
        interop.assert_trees_close(ks, ps, rtol=0, atol=0, what=f"max members slice {s}")
    assert int((ks.mcid >= 0).sum()) > 4096


def test_exact_kernel_limits(cuda):
    x = torch.zeros(8, dtype=torch.int32, device=cuda)
    v = torch.ones(8, dtype=torch.bool, device=cuda)
    for cfg in (ClusterConfig(max_clusters=aek.MAX_CLUSTERS + 1),
                ClusterConfig(max_members=aek.MAX_MEMBERS + 1),
                ClusterConfig(kappa=2)):
        with pytest.raises(ValueError):
            aek.update_slice_kernel(ae.init_state(cfg, device=cuda), x, x, x, x, v, cfg)


# ---------------------------------------------------------------- app C and D

def _pixel_cloud(seed, n=3000):
    """Event-like integer pixels: three blobs and scattered noise."""
    rng = np.random.default_rng(seed)
    pts = np.concatenate([rng.normal(c, 8.0, (n // 3, 2))
                          for c in ((100, 100), (300, 200), (200, 60))]
                         + [rng.uniform(0, (400, 300), (n // 10, 2))])
    return np.clip(np.round(pts), 0, 399).astype(np.float32)


def _metric_cloud(seed, n=20000):
    """A noisy plane z = 0.3 and two blobs above it, in metres."""
    rng = np.random.default_rng(seed)
    plane = np.stack([rng.uniform(0, 1, n), rng.uniform(0, 1, n),
                      0.3 + rng.normal(0, 0.005, n)], 1)
    blobs = [rng.normal(c, 0.03, (n // 4, 3)) for c in ((0.3, 0.3, 0.6), (0.7, 0.6, 0.5))]
    return np.concatenate([plane] + blobs).astype(np.float32)


def test_kmeans_on_card_matches_cpu(cuda):
    """App D's ramp and pixel blobs: counts and iters equal, centroids
    within 1e-4, labels equal except at near-ties; two calls bit-equal."""
    from evflow_tpu_torch.models import kmeans
    ramp = (synthetic.kmeans_ramp_data(2048), synthetic.kmeans_initial_centroids())
    pix = _pixel_cloud(1)
    for pts, init in (ramp, (pix, pix[::400][:8])):
        got = kmeans.kmeans(torch.as_tensor(pts, device=cuda), torch.as_tensor(init, device=cuda))
        again = kmeans.kmeans(torch.as_tensor(pts, device=cuda),
                              torch.as_tensor(init, device=cuda))
        interop.assert_trees_close(got, again, rtol=0, atol=0)
        ref = kmeans.kmeans(torch.as_tensor(pts), torch.as_tensor(init))
        assert torch.equal(got.counts.cpu(), ref.counts) and int(got.iters) == int(ref.iters)
        torch.testing.assert_close(got.centroids.cpu(), ref.centroids, rtol=0, atol=1e-4)
        differ = (got.labels.cpu() != ref.labels).numpy()
        d = np.sort(np.linalg.norm(pts[:, None] - ref.centroids.numpy()[None], axis=2), 1)
        assert (d[differ, 1] - d[differ, 0] < 1e-3).all()


@pytest.mark.parametrize("block", [2048, 333])
def test_dbscan_on_card_bit_equal_on_pixels(cuda, block):
    """Dense DBSCAN on integer pixels: labels, clusters, core mask and
    iterations the same bits as on the CPU. `block` sizes the CPU's
    panels; the card's kernel takes no block, so there both cases run it
    alike."""
    from evflow_tpu_torch.config import DBSCANConfig
    from evflow_tpu_torch.models import dbscan
    pts = _pixel_cloud(2)
    valid = np.random.default_rng(3).random(len(pts)) < 0.95
    cfg = DBSCANConfig(min_cluster_size=50)
    got = dbscan.dbscan(torch.as_tensor(pts, device=cuda), torch.as_tensor(valid, device=cuda),
                        cfg=cfg, block=block)
    ref = dbscan.dbscan(torch.as_tensor(pts), torch.as_tensor(valid), cfg=cfg, block=block)
    interop.assert_trees_close(got, ref, rtol=0, atol=0)
    assert int(got.num_clusters) == 3


def _eps_case(kind):
    """(rows, points, eps, point flags, row flags) of one eps-kernel case:
    rows are a slice of the points, as in dbscan_sharded's row block."""
    rng = np.random.default_rng(21)
    lo, hi, eps = 0, None, 20.0
    if kind == "floats":          # non-integer: an FMA contraction shows
        pts = (rng.uniform(0, 300, (5000, 2)) * 1.37).astype(np.float32)
        eps = 7.3
    elif kind == "parked":        # invalid lanes at _FAR: NaN pairs between them
        pts = _pixel_cloud(22, 4000)
    elif kind == "at-eps":        # integer pairs at exactly eps: (0,0)-(12,16) at eps 20
        base = rng.integers(0, 400, (600, 2))
        offs = np.array([[12, 16], [16, 12], [20, 0], [0, 20], [-12, 16], [16, -12]])
        pts = np.concatenate([base] + [base + o for o in offs]).astype(np.float32)
    elif kind == "duplicates":    # many points on few pixels
        pts = rng.integers(0, 30, (4000, 2)).astype(np.float32)
    elif kind == "ragged":        # N not a multiple of the tile
        pts = _pixel_cloud(23, 16384 - 37)
    elif kind == "row-block":     # M != N
        pts, lo, hi = _pixel_cloud(24, 7001), 1000, 3500
    elif kind == "cloud-3d":      # D = 3, metres: non-integer, three-term norms
        pts, eps = _metric_cloud(28, n=6000), 0.05
    else:                         # "cloud-3d-parked": D = 3 with parked lanes, a row block
        pts, lo, hi, eps = _metric_cloud(29, n=5000), 700, 4100, 0.05
    valid = rng.random(len(pts)) < (0.7 if kind.endswith("parked") else 0.95)
    pts = np.where(valid[:, None], pts, np.float32(dbscan._FAR)).astype(np.float32)
    sl = slice(lo, hi)
    return pts[sl], pts, eps, valid, valid[sl]


@pytest.mark.parametrize("kind", ["floats", "parked", "at-eps", "duplicates", "ragged",
                                  "row-block", "cloud-3d", "cloud-3d-parked"])
def test_dbscan_eps_kernel_bit_equal_to_panels(cuda, kind):
    """csrc/dbscan_eps.cu in both modes against the (block, N) panels on the
    card: counts, the lowest core label with and without the propagation
    round's epilogue; three launches."""
    rows, pts, eps, valid, row_valid = _eps_case(kind)
    rows, pts, valid, row_valid = (torch.as_tensor(a, device=cuda)
                                   for a in (rows, pts, valid, row_valid))
    rng = np.random.default_rng(25)
    n, m = pts.shape[0], rows.shape[0]
    labels = torch.as_tensor(rng.integers(0, n, n).astype(np.int32), device=cuda)
    core = valid & torch.as_tensor(rng.random(n) < 0.6, device=cuda)
    row_labels = torch.as_tensor(rng.integers(0, n, m).astype(np.int32), device=cuda)
    row_core = torch.as_tensor(rng.random(m) < 0.6, device=cuda)
    calls = [
        (distance.eps_counts, distance.eps_counts_plain, (rows, pts, eps, valid, row_valid)),
        (distance.eps_min_label, distance.eps_min_label_plain, (rows, pts, eps, labels, core)),
        (distance.eps_min_label, distance.eps_min_label_plain,
         (rows, pts, eps, labels, core, row_labels, row_core)),
    ]
    before = kernels.LAUNCHES["dbscan_eps"]
    results = []
    for fn, plain, args in calls:
        got, want = fn(*args), plain(*args)
        torch.cuda.synchronize()
        assert got.dtype == want.dtype == torch.int32 and got.shape == (m,)
        assert torch.equal(got, want), (fn.__name__, int((got != want).sum()))
        results.append(got)
    assert kernels.LAUNCHES["dbscan_eps"] == before + 3
    assert int(results[0].max()) > 1                      # the case has neighbours
    if kind.endswith("parked"):
        assert int((~valid).sum()) > 1000


def test_dbscan_slice_on_card_bit_equal_to_cpu(cuda):
    """App C on one textured 16384-event 1280x720 slice (the benchmark's
    scene): dense on the card, rounds + 2 eps launches, every field the
    same bits as the CPU's."""
    from evflow_tpu_torch.config import DBSCANConfig
    st = synthetic.textured_field_stream(num_slices=2, events_per_slice=16384, seed=31)
    sl = slice_by_count(st, 16384, drop_partial=True)
    x, y, v = (torch.as_tensor(np.ascontiguousarray(a[1]))
               for a in (sl.x, sl.y, sl.valid_mask()))
    before = kernels.LAUNCHES["dbscan_eps"]
    got = dbscan.dbscan_slice(x.to(cuda), y.to(cuda), v.to(cuda), DBSCANConfig())
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["dbscan_eps"] == before + int(got.iterations) + 2
    ref = dbscan.dbscan_slice(x, y, v, DBSCANConfig())
    interop.assert_trees_close(got, ref, rtol=0, atol=0)
    assert int(got.num_clusters) > 10


def test_dbscan_eps_launches_per_dense_call(cuda):
    """One dense dbscan call launches the kernel rounds + 2 times: the core
    counts, one per propagation round, the border attachment."""
    from evflow_tpu_torch.config import DBSCANConfig
    pts = torch.as_tensor(_pixel_cloud(26), device=cuda)
    before = kernels.LAUNCHES["dbscan_eps"]
    res = dbscan.dbscan(pts, cfg=DBSCANConfig(min_cluster_size=50))
    assert kernels.LAUNCHES["dbscan_eps"] == before + int(res.iterations) + 2
    assert int(res.iterations) > 1


def test_dbscan_eps_three_dimensions_on_card(cuda):
    """Dense DBSCAN at D = 3 (the metric cloud's two blobs) on the card:
    rounds + 2 launches, every field the same bits as the CPU's panels,
    both blobs found. A D other than 2 or 3 raises on the card."""
    from evflow_tpu_torch.config import DBSCANConfig
    pts = _metric_cloud(27, n=8000)
    pts = pts[pts[:, 2] > 0.4]
    cfg = DBSCANConfig(eps=0.05, core_min_pts=10, min_cluster_size=100)
    before = kernels.LAUNCHES["dbscan_eps"]
    got = dbscan.dbscan(torch.as_tensor(pts, device=cuda), cfg=cfg)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["dbscan_eps"] == before + int(got.iterations) + 2
    ref = dbscan.dbscan(torch.as_tensor(pts), cfg=cfg)
    interop.assert_trees_close(got, ref, rtol=0, atol=0)
    assert int(got.num_clusters) == 2
    wide = torch.zeros((64, 4), device=cuda)
    with pytest.raises(ValueError, match="2-D or 3-D"):
        distance.radius_neighbor_counts(wide, 1.0)


@pytest.mark.parametrize("kind", ["pixels", "metric"])
def test_grid_neighbors_and_dbscan_grid_on_card(cuda, kind):
    """compute_neighbors_grid and dbscan_grid on the card against the CPU:
    neighbor indices, counts and DBSCAN results equal, distances within
    one ulp; the table holds every row, so dbscan_grid took the grid."""
    from evflow_tpu_torch.config import DBSCANConfig
    from evflow_tpu_torch.models import dbscan, optics
    if kind == "pixels":
        pts, cfg = _pixel_cloud(4), DBSCANConfig(min_cluster_size=50)
    else:
        pts = _metric_cloud(5, n=8000)
        pts = pts[pts[:, 2] > 0.4]                    # the two blobs
        cfg = DBSCANConfig(eps=0.05, core_min_pts=10, min_cluster_size=100)
    got = optics.compute_neighbors_grid(pts, cfg.eps, cfg.core_min_pts, max_neighbors=2048,
                                        device=cuda)
    ref = optics.compute_neighbors_grid(pts, cfg.eps, cfg.core_min_pts, max_neighbors=2048,
                                        device="cpu")
    assert got is not None and int(got.count.max()) <= got.idx.shape[1]
    for name in ("idx", "count"):
        assert torch.equal(getattr(got, name).cpu(), getattr(ref, name)), name
    for name in ("dist", "core_dist"):
        torch.testing.assert_close(getattr(got, name).cpu(), getattr(ref, name),
                                   rtol=2.5e-7, atol=0)
    res = dbscan.dbscan_grid(pts, cfg, max_neighbors=2048, device=cuda)
    interop.assert_trees_close(res, dbscan.dbscan_grid(pts, cfg, max_neighbors=2048,
                                                       device="cpu"), rtol=0, atol=0)
    assert int(res.num_clusters) == (3 if kind == "pixels" else 2)


def test_voxel_and_ransac_on_card(cuda):
    """Voxel counts equal and centroids within 1e-6 of the CPU's, two calls
    bit-equal; RANSAC (the same seeded draw) gives the CPU's plane and
    inliers."""
    from evflow_tpu_torch.models import pointcloud
    pts = _metric_cloud(6)
    voxels = {}
    for buckets in (1 << 16, 1000):
        got = pointcloud.voxel_downsample(torch.as_tensor(pts, device=cuda), 0.01,
                                          num_buckets=buckets)
        again = pointcloud.voxel_downsample(torch.as_tensor(pts, device=cuda), 0.01,
                                            num_buckets=buckets)
        interop.assert_trees_close(got, again, rtol=0, atol=0)
        ref = pointcloud.voxel_downsample(torch.as_tensor(pts), 0.01, num_buckets=buckets)
        assert int(got.count) == int(ref.count) and torch.equal(got.valid.cpu(), ref.valid)
        torch.testing.assert_close(got.points.cpu(), ref.points, rtol=0, atol=1e-6)
        voxels[buckets] = got
    vp = voxels[1 << 16].points[voxels[1 << 16].valid]
    plane = pointcloud.ransac_plane(vp, threshold=0.02, iters=100)
    pref = pointcloud.ransac_plane(vp.cpu(), threshold=0.02, iters=100)
    assert torch.equal(plane.inliers.cpu(), pref.inliers)
    torch.testing.assert_close(plane.coeffs.cpu(), pref.coeffs, rtol=0, atol=1e-6)
    assert abs(float(plane.coeffs[2])) > 0.95


def test_float_segment_sums_deterministic(cuda):
    """masked_segment_sum on floats: two calls on the card give the same
    bits (no float atomics), 1-D and 2-D values, and match the CPU's
    in-order sums within f32 order."""
    from evflow_tpu_torch.ops import segment
    rng = np.random.default_rng(7)
    n, k = 1 << 18, 1000
    ids = torch.as_tensor(rng.integers(0, k, n).astype(np.int32), device=cuda)
    ids[: n // 2] = 3                                # one long run
    valid = torch.as_tensor(rng.random(n) < 0.9, device=cuda)
    for vals in (rng.normal(0, 100, n), rng.normal(0, 100, (n, 3))):
        v = torch.as_tensor(vals.astype(np.float32), device=cuda)
        a = segment.masked_segment_sum(v, ids, k, valid)
        b = segment.masked_segment_sum(v, ids, k, valid)
        assert torch.equal(a, b)
        ref = segment.masked_segment_sum(v.cpu(), ids.cpu(), k, valid.cpu())
        torch.testing.assert_close(a.cpu(), ref, rtol=1e-4, atol=1e-2)


def test_neighbor_counts_ignore_matmul_precision(cuda):
    """Under float32 matmul precision "high" (TF32 allowed in matmuls),
    neighbor counts and DBSCAN on coordinates around 1e3 are unchanged
    and equal the float64 oracle's (tests/test_ops.py's points and gate):
    no matmul carries the distances."""
    from evflow_tpu_torch.config import DBSCANConfig
    from evflow_tpu_torch.models import dbscan
    from evflow_tpu_torch.ops import distance
    rng = np.random.default_rng(5)
    pts = rng.uniform(0, 1000, (2048, 2)).astype(np.float32)
    oracle = (((pts[:, None, :].astype(np.float64) - pts[None]) ** 2).sum(-1)
              <= 5.64 ** 2).sum(1)
    p = torch.as_tensor(pts, device=cuda)
    prev = torch.get_float32_matmul_precision()
    try:
        runs = []
        for precision in ("highest", "high"):
            torch.set_float32_matmul_precision(precision)
            runs.append((distance.radius_neighbor_counts(p, 5.64).cpu(),
                         dbscan.dbscan(p, cfg=DBSCANConfig(eps=5.64, core_min_pts=3,
                                                           min_cluster_size=3))))
    finally:
        torch.set_float32_matmul_precision(prev)
    np.testing.assert_array_equal(runs[0][0].numpy(), oracle)
    assert torch.equal(runs[0][0], runs[1][0])
    interop.assert_trees_close(runs[0][1], runs[1][1], rtol=0, atol=0)


def test_stack_path_on_card_matches_cpu(cuda):
    """full_scan at q=8 with micro_stack on the card: the fastcluster
    kernels and the candidates launch each slice, the ring test once a
    slice in the stack form and each sub-slice in the serial form; the corner chain equals the
    card's serial q=8 run bit for bit and the CPU's within the tracker
    tolerance."""
    n = 2048
    cfg = dataclasses.replace(
        DEFAULT, sensor=SensorConfig(width=256, height=120),
        slicing=SliceConfig(n_events=n),
        efast=dataclasses.replace(DEFAULT.efast, max_candidates=1024, micro_slices=8),
        nms=NMSConfig(max_corners=128), tracker=TrackerConfig(max_tracks=64),
        cluster=ClusterConfig(max_clusters=32))
    stack = dataclasses.replace(cfg, efast=dataclasses.replace(cfg.efast, micro_stack=True))
    stream = synthetic.moving_blob_stream(
        num_slices=6, events_per_slice=n,
        blob_centers=((60.0, 50.0), (180.0, 70.0), (120.0, 30.0)),
        velocities=((4.0, 1.0), (-3.0, 2.0), (1.0, -1.0)), sigma=6.0,
        width=256, height=120)
    sl = slice_by_count(stream, n, drop_partial=True)
    arrays = (sl.x, sl.y, (sl.t - int(stream.t[0])).astype(np.int32), sl.valid_mask())

    def scan(device, c):
        cl = fastcluster.init_state(c.cluster, device=device)
        co = pipeline.init_corner_state(c, device=device)
        return pipeline.full_scan(cl, co, *[torch.as_tensor(a, device=device)
                                            for a in arrays], c)

    kernels.reset_launches()
    got = scan(cuda, stack)
    assert kernels.LAUNCHES == {"efast_stencil": 0, "efast_ring": 6, "assign_manhattan": 6,
                                "cluster_stats": 6, "aeclustering_exact": 0,
                                "dbscan_eps": 0, "rep_candidates": 6}, kernels.LAUNCHES
    kernels.reset_launches()
    serial = scan(cuda, cfg)
    assert kernels.LAUNCHES["efast_ring"] == 6 * 8, kernels.LAUNCHES
    assert kernels.LAUNCHES["rep_candidates"] == 6, kernels.LAUNCHES
    interop.assert_trees_close(got, serial, rtol=0, atol=0, what="stack vs serial")
    (gcl, gco), (gclo, gcoo) = got
    (wcl, wco), (wclo, wcoo) = scan("cpu", stack)
    interop.assert_trees_close((gcl, gclo), (wcl, wclo), rtol=1e-5, atol=1e-3)
    interop.assert_trees_close((gco, gcoo), (wco, wcoo), rtol=1e-5, atol=1e-4)
    assert int(gcoo.num_corners.sum()) > 0


# ------------------------------------------------ representative candidates

def _candidate_rows(kind, r, n, m, rng):
    """(x, y, valid) int32, int32, bool numpy rows on the 1280x720 sensor:
    `uniform` pixels (more representatives than any cap here), `few` (a
    10 x 10 box: fewer than m), `exact` (lane % m: m representatives when
    n >= m), `one-pixel`, `invalid` (no valid lane), `edges` (off the
    sensor: negative, at and past W and H, beyond H + 1, keys that wrap
    int32)."""
    x = rng.integers(0, 1280, (r, n))
    y = rng.integers(0, 720, (r, n))
    valid = rng.random((r, n)) < 0.9
    if kind == "few":
        x, y = rng.integers(100, 110, (r, n)), rng.integers(50, 60, (r, n))
    elif kind == "exact":
        x, y, valid[:] = np.arange(n)[None, :] % m + 0 * x, 3 + 0 * y, True
    elif kind == "one-pixel":
        x, y, valid[:] = 640 + 0 * x, 360 + 0 * y, True
    elif kind == "invalid":
        valid[:] = False
    elif kind == "edges":
        pick = rng.integers(0, 7, (r, n))
        x = np.where(pick == 1, rng.integers(-4, 0, (r, n)), x)
        x = np.where(pick == 2, rng.integers(1280, 1284, (r, n)), x)
        y = np.where(pick == 3, rng.integers(720, 725, (r, n)), y)
        y = np.where(pick == 4, rng.integers(-3, 0, (r, n)), y)
        y = np.where(pick == 5, rng.choice([2 ** 31 - 1, -2 ** 31, 1_700_000_000], (r, n)), y)
        x = np.where(pick >= 5, rng.integers(-2 ** 31, 2 ** 31 - 1, (r, n)), x)
    return x.astype(np.int32), y.astype(np.int32), valid


@pytest.mark.parametrize("r,n,m", [(8, 2048, 1024), (1, 16384, 8192), (3, 100, 256),
                                   (8, 2048, 64), (2, 20000, 9000)])
@pytest.mark.parametrize("kind", ["uniform", "few", "exact", "one-pixel", "invalid", "edges"])
def test_rep_candidates_matches_plain(cuda, r, n, m, kind):
    """csrc/rep_candidates.cu against the plain form on each row, every
    output bit-equal, n_dropped included: the q=8 rows and the q=1 row (in
    shared memory), m > n, a small cap, and rows of 20,000 (the table in a
    global workspace); representatives fewer than, as many as and more
    than m."""
    rng = np.random.default_rng(n + m + len(kind))
    x, y, valid = _candidate_rows(kind, r, n, m, rng)
    xs, ys, vs = (torch.as_tensor(a, device=cuda) for a in (x, y, valid))
    before = kernels.LAUNCHES["rep_candidates"]
    got = pipeline.representative_candidates(xs, ys, vs, m, DEFAULT)
    assert kernels.LAUNCHES["rep_candidates"] == before + 1
    reps = []
    for k in range(r):
        want = pipeline._representative_candidates(xs[k], ys[k], vs[k], m, DEFAULT)
        for name, g, w in zip(("cx", "cy", "cvalid", "n_dropped"), got, want):
            assert torch.equal(g[k], w), (name, k, int((g[k] != w).sum()))
        reps.append(int(want[2].sum()) + int(want[3]))
    if kind == "exact" and n >= m:
        assert reps == [m] * r
    if kind == "invalid":
        assert reps == [0] * r


def test_rep_candidates_empty_and_reused_outputs(cuda):
    """No row launches nothing; a second call over garbage in the caching
    allocator's blocks still writes every output element."""
    x = torch.zeros((0, 64), dtype=torch.int32, device=cuda)
    before = kernels.LAUNCHES["rep_candidates"]
    cx, cy, cv, nd = pipeline.representative_candidates(
        x, x, torch.zeros((0, 64), dtype=torch.bool, device=cuda), 32, DEFAULT)
    assert cx.shape == (0, 32) and nd.shape == (0,)
    assert kernels.LAUNCHES["rep_candidates"] == before
    rng = np.random.default_rng(5)
    x, y, valid = (torch.as_tensor(a, device=cuda) for a in _candidate_rows("few", 8, 2048, 1024, rng))
    for fill in (0x7f, 0x00):
        torch.full((1 << 20,), fill, dtype=torch.uint8, device=cuda)   # dirty the pool
        got = pipeline.representative_candidates(x, y, valid, 1024, DEFAULT)
        want = pipeline.representative_candidates(x.cpu(), y.cpu(), valid.cpu(), 1024, DEFAULT)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)


def test_full_scan_q8_at_hd_track_settings_matches_cpu(cuda):
    """full_scan at hd_track_q8's settings (DEFAULT at q=8: 1280x720,
    16384 events, a cap of 1,024 candidates per sub-slice) over 4 slices of
    the textured scene, where the cap binds: one rep_candidates launch per
    slice, and the corner chain equal to the CPU run (its counts, drops and
    track ids exactly, track floats within the suite's tracker tolerance),
    cluster floats within f32 order."""
    cfg = dataclasses.replace(DEFAULT, efast=dataclasses.replace(DEFAULT.efast, micro_slices=8))
    n = cfg.slicing.n_events
    stream = synthetic.textured_field_stream(num_slices=4, events_per_slice=n, seed=3)
    sl = slice_by_count(stream, n, drop_partial=True)
    arrays = (sl.x, sl.y, (sl.t - int(stream.t[0])).astype(np.int32), sl.valid_mask())

    def scan(device):
        cl = fastcluster.init_state(cfg.cluster, device=device)
        co = pipeline.init_corner_state(cfg, device=device)
        return pipeline.full_scan(cl, co, *[torch.as_tensor(a, device=device)
                                            for a in arrays], cfg)

    kernels.reset_launches()
    (gcl, gco), (gclo, gcoo) = scan(cuda)
    assert kernels.LAUNCHES["rep_candidates"] == sl.num_slices, kernels.LAUNCHES
    assert kernels.LAUNCHES["efast_ring"] == 8 * sl.num_slices, kernels.LAUNCHES
    (wcl, wco), (wclo, wcoo) = scan("cpu")
    interop.assert_trees_close((gcl, gclo), (wcl, wclo), rtol=1e-5, atol=1e-3)
    interop.assert_trees_close((gco, gcoo), (wco, wcoo), rtol=1e-5, atol=1e-4)
    for name in ("num_corners", "num_filtered", "num_dropped", "track_active", "track_label"):
        assert torch.equal(getattr(gcoo, name).cpu(), getattr(wcoo, name)), name
    assert int(gcoo.num_dropped.min()) > 0, gcoo.num_dropped


# ---------------------------------------------------------------- app B

@pytest.mark.parametrize("method", ["cellpair", "grid", "dense", "certified"])
def test_optics_on_card_matches_cpu(cuda, method):
    """OPTICS on integer pixels: each backend's table on the card has the
    CPU's bits (after the auto-raise, where a neighborhood overflows K),
    and the sweeps give the same order and reach."""
    from evflow_tpu_torch.models import optics
    pts = _pixel_cloud(7)
    got = optics.neighbor_table(pts, 4, 6.0, max_neighbors=64, method=method, device=cuda)
    ref = optics.neighbor_table(pts, 4, 6.0, max_neighbors=64, method=method, device="cpu")
    for name in got._fields:
        assert torch.equal(getattr(got, name).cpu(), getattr(ref, name)), name
    host = [optics.table_to_host(t) for t in (got, ref)]
    assert optics.sweep(*host[0]) == optics.sweep(*host[1])


def test_optics_dense_ties_on_card(cuda):
    """36 neighbors at exactly one distance and K = 8: the card keeps the
    lowest indices, as lax.top_k does and as the CPU run does."""
    from evflow_tpu_torch.models import optics
    ring = [(5, 0), (0, 5), (-5, 0), (0, -5), (3, 4), (4, 3), (-3, 4), (-4, 3),
            (3, -4), (4, -3), (-3, -4), (-4, -3)]
    pts = np.array([(0, 0)] + ring * 3 + [(40, 40)], np.float64)
    pts = pts[np.concatenate([[0], 1 + np.random.default_rng(0).permutation(len(pts) - 1)])]
    for fn in (optics.compute_neighbors, optics.compute_neighbors_certified):
        got = fn(pts, 6.0, 3, max_neighbors=8, device=cuda)
        ref = fn(pts, 6.0, 3, max_neighbors=8, device="cpu")
        assert torch.equal(got.idx.cpu(), ref.idx)
        tied = np.nonzero(np.hypot(*pts.T) == 5.0)[0]
        assert got.idx[0].tolist() == [0] + sorted(tied.tolist())[:7]


def test_optics_scan_on_card_matches_cpu(cuda):
    """App B per slice on two DEFAULT textured slices (a block of lanes
    invalid in the second): one `dbscan_eps` count launch a slice sizes K,
    and order, reach, membership, count, sizes and centroids have the CPU
    run's bits (integer pixels); variances within float32 summation order."""
    n = DEFAULT.slicing.n_events
    stream = synthetic.textured_field_stream(num_slices=2, events_per_slice=n, seed=5)
    sl = slice_by_count(stream, n, drop_partial=True)
    valid = sl.valid_mask()
    valid[1, 4000:6000] = False
    cfg = dataclasses.replace(DEFAULT, optics=dataclasses.replace(DEFAULT.optics, epsilon=10.0))

    def scan(device):
        xs, ys, vs = (torch.as_tensor(a, device=device) for a in (sl.x, sl.y, valid))
        state = torch.zeros((), dtype=torch.int32, device=device)
        return pipeline.optics_scan(state, xs, ys, None, vs, cfg, 10.0)[1]

    kernels.reset_launches()
    got = scan(cuda)
    assert kernels.LAUNCHES["dbscan_eps"] == sl.num_slices, kernels.LAUNCHES
    # a CPU build's first large float32 sqrt may run some threads at reduced
    # accuracy: one first keeps the compared run on the accurate path
    torch.sqrt(torch.rand(2048, n))
    want = scan("cpu")
    for name in ("order", "reach", "cluster", "num_clusters", "size", "centroid"):
        assert torch.equal(getattr(got, name).cpu(), getattr(want, name)), name
    torch.testing.assert_close(got.variance.cpu(), want.variance, rtol=1e-5, atol=1e-5)
    assert int(want.num_clusters.min()) > 1000
    # a slice with no valid event, and one with a single one
    xs = torch.arange(128, device=cuda).reshape(2, 64)
    vs = torch.zeros((2, 64), dtype=torch.bool, device=cuda)
    vs[1, 5] = True
    _, few = pipeline.optics_scan(torch.zeros((), dtype=torch.int32, device=cuda), xs, xs, None,
                                  vs, cfg, 10.0)
    assert few.num_clusters.tolist() == [0, 1] and few.order[:, 0].tolist() == [-1, 5]


# ---------------------------------------------------------------- the CLI

def test_cli_async_cluster_on_card_matches_cpu(cuda, tmp_path, capsys):
    """app A through the CLI: a decimated stream of 32,768 events as one
    slice, one launch of the exact kernel (its lane compaction and ring
    staging at N in the tens of thousands), the printed clusters equal to
    the CPU run's (the exact engine is bit-equal)."""
    from evflow_tpu_torch.io import save_csv
    from evflow_tpu_torch.run import main
    stream = synthetic.moving_blob_stream(
        num_slices=8, events_per_slice=16384,
        blob_centers=((200.0, 200.0), (900.0, 500.0), (600.0, 150.0)),
        velocities=((30.0, 10.0), (-20.0, 15.0), (5.0, -12.0)), sigma=12.0, seed=42)
    path = str(tmp_path / "s.csv")
    save_csv(stream, path)
    argv = ["async-cluster", "--input", path, "--decimate", "4"]
    kernels.reset_launches()
    main(argv)
    got = capsys.readouterr().out
    assert kernels.LAUNCHES["aeclustering_exact"] == 1
    main(argv + ["--device", "cpu"])
    want = capsys.readouterr().out
    assert got == want
    assert got.startswith("events=32768 clusters=") and got.count("cid=") > 0


@pytest.mark.parametrize("exact", [False, True])
def test_dedup_batched_on_card_matches_cpu(cuda, exact):
    from evflow_tpu_torch.config import DedupConfig
    from evflow_tpu_torch.ops import hash_dedup
    rng = np.random.default_rng(21)
    s, n = 8, 16384
    x = torch.as_tensor(rng.integers(-2, 1283, (s, n)).astype(np.int32))
    y = torch.as_tensor(rng.integers(-2, 723, (s, n)).astype(np.int32))
    v = torch.as_tensor(rng.random((s, n)) < 0.9)
    cfg = DedupConfig(exact=exact)
    got = hash_dedup.dedup_batched(x.to(cuda), y.to(cuda), v.to(cuda), cfg)
    want = hash_dedup.dedup_batched(x, y, v, cfg)
    interop.assert_trees_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("n,c,kind", [(16384, 128, "random"), (16384, 128, "one"),
                                      (65536, 4096, "random"), (1000, 1, "one")])
def test_cluster_stats_k_after_matches_plain(cuda, n, c, kind):
    """The later tiles' counts (k_after) extend every exponent: small ones
    keep the newest members' weights above the clamp at 80, large ones
    (2^30, past any rank) reach it without overflow, zeros give the bits of
    no k_after; counts stay this call's own."""
    labels, x, y = _stats_inputs(n, c, kind, cuda)
    rng = np.random.default_rng(c)
    for k_after in (rng.integers(0, 60, c), np.full(c, 1 << 30), np.zeros(c)):
        k_after = torch.as_tensor(k_after.astype(np.int32), device=cuda)
        before = kernels.LAUNCHES["cluster_stats"]
        got = ck.cluster_stats(labels, x, y, 0.3, c, k_after)
        _stats_close(got, ck.cluster_stats_plain(labels, x, y, 0.3, c, k_after))
        assert kernels.LAUNCHES["cluster_stats"] == before + 1
    assert torch.equal(got, ck.cluster_stats(labels, x, y, 0.3, c))


def test_tiled_cluster_and_corner_steps_on_card_match_cpu(cuda):
    """One rank of the tiled steps (a tile mesh of one: k_after of zeros
    passed to the kernel, no collective) over 6 DEFAULT slices on the card
    against the same steps on the CPU: cluster floats within f32 order,
    everything else equal."""
    from evflow_tpu_torch.parallel import mesh, tiling
    cfg = DEFAULT
    stream = synthetic.moving_blob_stream(
        num_slices=6, events_per_slice=cfg.slicing.n_events,
        blob_centers=((200.0, 200.0), (900.0, 500.0)), velocities=((30.0, 10.0), (-20.0, 15.0)),
        sigma=12.0, seed=4)
    sl = slice_by_count(stream, cfg.slicing.n_events)
    t = (sl.t - sl.t[0, 0]).astype(np.int32)
    m = mesh.make_tile_mesh(1)
    runs = {}
    for dev in (cuda, torch.device("cpu")):
        step = tiling.make_tiled_cluster_flow_step(m, cfg)
        cstep = tiling.make_tiled_corner_step(m, 1, cfg)
        st = fastcluster.init_state(cfg.cluster, device=dev)
        co = tiling.init_tiled_corner_state(m, 1, cfg, device=dev)
        outs = []
        before = dict(kernels.LAUNCHES)
        for s in range(sl.num_slices):
            x, y, tt, v = (torch.as_tensor(a[s], device=dev)
                           for a in (sl.x, sl.y, t, sl.valid_mask()))
            st, out, uc, rc = step(st, x, y, v)
            *co, cout = cstep(*co, x, y, tt, v)
            outs.append(interop.to_leaves((st, out, uc, rc, co, cout)))
        runs[dev.type] = outs
        if dev.type == "cuda":
            for name in ("assign_manhattan", "cluster_stats", "efast_ring"):
                assert kernels.LAUNCHES[name] == before[name] + sl.num_slices
    for s, (got, want) in enumerate(zip(runs["cuda"], runs["cpu"])):
        for a, b in zip(got, want):
            if a.dtype.kind == "f":
                np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-3, err_msg=f"slice {s}")
            else:
                np.testing.assert_array_equal(a, b, err_msg=f"slice {s}")
