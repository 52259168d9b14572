"""Parity of the PyTorch port's clustering and tracking with the JAX package:
the two fastcluster kernels' plain versions against the Pallas kernels (in
interpret mode) and their jnp oracles, `fastcluster.update_slice` over
several slices and the committed golden file, and `tracker.update`.

Tolerances: labels, counts, ranks and every bool/int state field exact;
the EWMA-weighted sums differ only in f32 summation order (the port sums
per cluster, JAX through a one-hot matmul), so cluster floats are held at
rtol 1e-5, atol 1e-3; tracker floats at rtol 1e-5, atol 1e-4.

The CUDA kernels themselves run only on a card (`-m cuda`, see README)."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from evflow_tpu.config import (DEFAULT, ClusterConfig, SensorConfig, SliceConfig,
                               TrackerConfig)
from evflow_tpu.io import load_csv
from evflow_tpu.models import fastcluster as jfc, tracker as jtracker
from evflow_tpu.ops import pallas_kernels as pk
from evflow_tpu_torch import interop
from evflow_tpu_torch.models import fastcluster, pipeline, tracker
from evflow_tpu_torch.ops import cluster_kernels as ck

torch.set_num_threads(2)

CLUSTER_TOL = dict(rtol=1e-5, atol=1e-3)
TRACK_TOL = dict(rtol=1e-5, atol=1e-4)
SENSOR = SensorConfig()
DATA_DIR = os.path.join(os.path.dirname(__file__), "data")


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _assign_inputs(rng, n=2048, c=128):
    x = rng.integers(0, 1280, n).astype(np.int32)
    y = rng.integers(0, 720, n).astype(np.int32)
    mu = (rng.random((c, 2)) * 800).astype(np.float32)
    mu[5] = mu[3]                     # a tie: the lower index must win
    alive = rng.random(c) > 0.4
    alive[3] = alive[5] = True
    x[:64] = np.round(mu[3, 0])
    y[:64] = np.round(mu[3, 1])
    return x, y, mu, alive


def test_assign_manhattan_matches_jax_kernel():
    rng = np.random.default_rng(0)
    x, y, mu, alive = _assign_inputs(rng)
    labels, dist = ck.assign_manhattan(_t(x), _t(y), _t(mu), _t(alive), 40.0)
    kl, kd = pk.assign_manhattan(jnp.asarray(x), jnp.asarray(y), jnp.asarray(mu),
                                 jnp.asarray(alive.astype(np.int32)), 40.0,
                                 tile_n=1024, interpret=True)
    rl, rd = pk.assign_manhattan_reference(jnp.asarray(x), jnp.asarray(y),
                                           jnp.asarray(mu),
                                           jnp.asarray(alive.astype(np.int32)), 40.0)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(rl))
    np.testing.assert_array_equal(dist.numpy(), np.asarray(rd))
    np.testing.assert_array_equal(labels.numpy(), np.asarray(kl))
    np.testing.assert_array_equal(dist.numpy(), np.asarray(kd))
    assert (labels[:64] == 3).all()


def test_assign_manhattan_no_alive():
    n, c = 512, 16
    z = torch.zeros(n, dtype=torch.int32)
    labels, dist = ck.assign_manhattan(z, z, torch.zeros((c, 2)),
                                       torch.zeros(c, dtype=torch.bool), 40.0)
    assert (labels == -1).all() and torch.isinf(dist).all()


def _stats_inputs(rng, n=2048, c=32):
    labels = rng.integers(-1, c, n).astype(np.int32)
    labels[rng.random(n) < 0.3] = 3   # one long run: exponents reach the clamp
    x = rng.integers(0, 1280, n).astype(np.float32)
    y = rng.integers(0, 720, n).astype(np.float32)
    return labels, x, y


@pytest.mark.parametrize("alpha", [0.5, 0.1])
def test_cluster_stats_matches_jax_kernel(alpha):
    rng = np.random.default_rng(1)
    c = 32
    labels, x, y = _stats_inputs(rng, c=c)
    got = ck.cluster_stats(_t(labels), _t(x), _t(y), alpha, c).numpy()
    kern = np.asarray(pk.cluster_stats(jnp.asarray(labels), jnp.asarray(x),
                                       jnp.asarray(y), alpha, c, interpret=True))
    ref = np.asarray(pk.cluster_stats_reference(jnp.asarray(labels), jnp.asarray(x),
                                                jnp.asarray(y), alpha, c))
    for want in (kern, ref):
        np.testing.assert_array_equal(got[:, :3], want[:, :3])   # k, sum x, sum y
        np.testing.assert_allclose(got[:, 3:], want[:, 3:], rtol=1e-5, atol=1e-3)
    np.testing.assert_array_equal(got[:, 0], np.bincount(labels[labels >= 0],
                                                         minlength=c))


def _blob_slices(rng, n, s_count, width=1000, height=700):
    for _ in range(s_count):
        cx = rng.uniform(50, width - 50, 5)
        cy = rng.uniform(50, height - 50, 5)
        k = rng.integers(0, 5, n)
        x = np.clip(cx[k] + rng.normal(0, 9, n), 0, width).astype(np.int32)
        y = np.clip(cy[k] + rng.normal(0, 9, n), 0, height).astype(np.int32)
        yield x, y, rng.random(n) < 0.9


@pytest.mark.parametrize("cfg", [
    ClusterConfig(max_clusters=64),
    ClusterConfig(max_clusters=32, radius=40.0, min_n=10, alpha=0.3),
], ids=["default", "accel"])
def test_update_slice_matches_jax(cfg):
    """Six slices of drifting blobs: every discrete field exact, floats at
    the stated tolerance, outputs and state both."""
    rng = np.random.default_rng(7)
    st_j = jfc.init_state(cfg)
    st_t = fastcluster.init_state(cfg, device="cpu")
    for s, (x, y, v) in enumerate(_blob_slices(rng, 2048, 6)):
        st_j, out_j = jfc.update_slice(st_j, jnp.asarray(x), jnp.asarray(y),
                                       jnp.asarray(v), cfg, SENSOR)
        st_t, out_t = fastcluster.update_slice(st_t, _t(x), _t(y), _t(v), cfg, SENSOR)
        interop.assert_trees_close((st_t, out_t), (st_j, out_j), **CLUSTER_TOL,
                                   what=f"slice {s}")
    assert int(out_t.reported.sum()) > 0 and bool((out_t.flow != 0).any())


GOLDEN_CFG = dataclasses.replace(
    DEFAULT, slicing=SliceConfig(n_events=64, mode="n_events"),
    cluster=ClusterConfig(radius=40.0, min_n=5, max_clusters=32))


def test_cluster_flow_matches_golden():
    """The committed golden cluster-flow reports (tests/test_golden.py), from
    the port, under that test's own check."""
    s = load_csv(os.path.join(DATA_DIR, "event_raw_data8.csv"))
    cfg = GOLDEN_CFG
    state = fastcluster.init_state(cfg.cluster, device="cpu")
    n = cfg.slicing.n_events
    got = []
    for start in range(0, len(s), n):
        sl = s[start:start + n]
        pad = n - len(sl)
        x = np.pad(sl.x, (0, pad)).astype(np.int32)
        y = np.pad(sl.y, (0, pad)).astype(np.int32)
        valid = np.arange(n) < len(sl)
        state, out = pipeline.cluster_flow_step(state, _t(x), _t(y), _t(valid), cfg)
        rows = [{"cid": int(out.cid[c]), "n": int(out.n[c]),
                 "centroid": out.centroid[c].tolist(), "flow": out.flow[c].tolist()}
                for c in torch.nonzero(out.reported).flatten().tolist()]
        got.append({"unique": int(out.unique_count),
                    "clusters": sorted(rows, key=lambda r: r["cid"])})
    with open(os.path.join(DATA_DIR, "golden_cluster_flow.json")) as f:
        exp = json.load(f)
    assert len(got) == len(exp)
    for g, e in zip(got, exp):
        assert g["unique"] == e["unique"]
        assert len(g["clusters"]) == len(e["clusters"])
        for gc, ec in zip(g["clusters"], e["clusters"]):
            assert gc["cid"] == ec["cid"] and gc["n"] == ec["n"]
            np.testing.assert_allclose(gc["centroid"], ec["centroid"], atol=0.05)
            np.testing.assert_allclose(gc["flow"], ec["flow"], atol=0.05)


def test_tracker_update_matches_jax():
    """Twelve steps of noisy detections around drifting targets, with some
    targets vanishing and new ones appearing: association, spawn, coast,
    prune and grouping all exercised."""
    cfg = TrackerConfig(max_tracks=64, history=6)
    rng = np.random.default_rng(11)
    d = 96
    targets = rng.uniform(20, 300, (40, 2))
    vel = rng.normal(0, 3, (40, 2))
    st_j, st_t = jtracker.init_state(cfg), tracker.init_state(cfg, device="cpu")
    for step in range(12):
        targets = targets + vel
        shown = rng.random(40) < 0.8
        det = targets[shown] + rng.normal(0, 0.7, (shown.sum(), 2))
        dx = np.zeros(d, np.float32)
        dy = np.zeros(d, np.float32)
        k = min(len(det), d)
        dx[:k], dy[:k] = det[:k, 0], det[:k, 1]
        dv = np.arange(d) < k
        st_j, g_j = jtracker.update(st_j, jnp.asarray(dx), jnp.asarray(dy),
                                    jnp.asarray(dv), cfg)
        st_t, g_t = tracker.update(st_t, _t(dx), _t(dy), _t(dv), cfg)
        interop.assert_trees_close((st_t, g_t), (st_j, g_j), **TRACK_TOL,
                                   what=f"step {step}")
    assert int(st_t.active.sum()) > 10 and int(g_t.exists.sum()) > 0
    assert int(st_t.hist_len.max()) == cfg.history


# ---- CPU models of the two kernels' designs (csrc/cluster_stats.cu and
# csrc/assign_manhattan.cu), in numpy, step for step: the CUDA sources run
# only on a card, so their partition, ordering and tie logic are held to the
# plain versions and to the JAX package here.

STATS_CTAS, STATS_WARPS = 8, 16
LANES = np.arange(32)


def _warp_sum4(v):
    """The kernel's 6-shuffle reduction of four values over 32 lanes, in
    its f32 order: the halves trade halves of the values, then each group
    of 8 lanes reduces one value; lane 8 q holds the sum of value q."""
    hi, h8 = (LANES & 16) > 0, (LANES & 8) > 0
    p, q = LANES ^ 16, LANES ^ 8
    a0 = np.where(hi, v[:, 2], v[:, 0]) + np.where(hi, v[p, 2], v[p, 0])
    a1 = np.where(hi, v[:, 3], v[:, 1]) + np.where(hi, v[p, 3], v[p, 1])
    b = np.where(h8, a1, a0) + np.where(h8, a1[q], a0[q])
    for o in (4, 2, 1):
        b = b + b[LANES ^ o]
    return b[[0, 8, 16, 24]]


def _rank_chunk(seg, warps, c):
    """One chunk's ranks and counting sort, as the kernel's steps 1-3:
    contiguous ranking-warp ranges walked 32 lanes a step (rank = the
    warp's running count plus equal labels on lower lanes), the warps'
    offsets, the per-cluster buckets. Returns the chunk's counts per
    cluster, the bucket starts and the sorted chunk indices."""
    t = -(-len(seg) // warps)
    wcnt = np.zeros((warps, c), np.int64)
    rank_w = np.full(len(seg), -1)
    for w in range(warps):
        end = min(len(seg), (w + 1) * t)
        for b in range(w * t, end, 32):
            step = seg[b:min(b + 32, end)]
            for lane, l in enumerate(step):
                if l >= 0:
                    rank_w[b + lane] = wcnt[w, l] + np.sum(step[:lane] == l)
            for l in np.unique(step[step >= 0]):
                wcnt[w, l] += np.sum(step == l)
    woff = np.cumsum(wcnt, 0) - wcnt
    counts = wcnt.sum(0)
    bucket = np.cumsum(counts) - counts
    order = np.full(int(counts.sum()), -1)
    for i in np.flatnonzero(seg >= 0):
        order[bucket[seg[i]] + woff[i // t, seg[i]] + rank_w[i]] = i
    # a permutation of the members, each bucket in stream order
    assert sorted(order.tolist()) == np.flatnonzero(seg >= 0).tolist()
    for j in range(c):
        b = order[bucket[j]:bucket[j] + counts[j]]
        assert (seg[b] == j).all() and (np.diff(b) > 0).all()
    return counts, bucket, order


def _stats_partition_model(labels, x, y, alpha, c, warps=STATS_WARPS, chunk=None):
    """csrc/cluster_stats.cu's partition: 8 contiguous CTA ranges of
    S = 4 ceil(N/32) events, each walked in chunks of `chunk` events (the
    whole range by default, as at the main path's size), each chunk ranked
    and sorted by `warps` ranking warps; the cross-CTA offsets and k; and
    the f32 sums in the kernel's order (lane-strided, its 6-shuffle
    reduction, added to the CTA's partial chunk by chunk, then the CTAs in
    rank order)."""
    n = len(labels)
    s = 4 * -(-n // 32)
    chunk = chunk or max(s, 4)
    lab = np.where((labels >= 0) & (labels < c), labels, -1)
    counts, ctas = np.zeros((STATS_CTAS, c), np.int64), []
    for r in range(STATS_CTAS):
        lo = min(n, r * s)
        hi = min(n, lo + s)
        chunks = []
        for clo in range(lo, hi, chunk):
            ccount, bucket, order = _rank_chunk(lab[clo:min(hi, clo + chunk)], warps, c)
            counts[r] += ccount
            chunks.append((clo, ccount, bucket, order))
        ctas.append(chunks)
    k = counts.sum(0)
    off = np.cumsum(counts, 0) - counts
    la = np.log1p(np.float32(-alpha), dtype=np.float32)
    out = np.zeros((c, 5), np.float32)
    out[:, 0] = k
    for j in range(c):
        acc = np.zeros(4, np.float32)
        for r, chunks in enumerate(ctas):
            part = np.zeros(4, np.float32)
            e = k[j] - 1 - off[r, j]      # exponent of the CTA's first member
            for clo, ccount, bucket, order in chunks:
                m = ccount[j]
                if m == 0:
                    continue
                idx = clo + order[bucket[j]:bucket[j] + m]
                expo = np.clip(e - np.arange(m), 0, 80).astype(np.float32)
                wgt = np.float32(alpha) * np.exp(expo * la, dtype=np.float32)
                v = np.zeros((32, 4), np.float32)
                for lane in range(32):
                    for q in range(lane, m, 32):
                        i = idx[q]
                        v[lane] += np.array([x[i], y[i], wgt[q] * x[i], wgt[q] * y[i]],
                                            np.float32)
                part = part + _warp_sum4(v)
                e -= m
            acc = acc + part
        out[j, 1:] = acc
    return out


def _stats_case(n, kind, c):
    rng = np.random.default_rng(n)
    labels = rng.integers(-1, c, n).astype(np.int32)
    if kind == "none":
        labels[:] = -1
    elif kind == "one":
        labels[:] = c - 1
    else:
        labels[rng.random(n) < 0.3] = 3
        labels[rng.random(n) < 0.05] = c + 5         # outside [0, C): no cluster
    # small coordinates for the one-cluster case keep sum x under 2^24
    hi = 64 if kind == "one" else 1280
    x = rng.integers(0, hi, n).astype(np.float32)
    y = rng.integers(0, min(hi, 720), n).astype(np.float32)
    return labels, x, y


@pytest.mark.parametrize("n,kind", [(1, "random"), (7, "random"), (1000, "random"),
                                    (2048, "random"), (16384, "random"),
                                    (1000, "none"), (2048, "one"), (7, "one")])
def test_cluster_stats_partition_model(n, kind):
    """The kernel's partition, modelled on the CPU, against the plain
    version and the JAX package (its Pallas kernel in interpret mode where
    N is a multiple of a tile, else its jnp oracle): counts and the integer
    sums exact, the weighted sums within the f32-order tolerance."""
    c, alpha = 32, 0.3
    labels, x, y = _stats_case(n, kind, c)
    got = _stats_partition_model(labels, x, y, alpha, c)
    plain = ck.cluster_stats_plain(_t(labels), _t(x), _t(y), alpha, c).numpy()
    jl, jx, jy = (jnp.asarray(a) for a in (np.where(labels < c, labels, -1), x, y))
    tile = {1000: 500, 2048: 1024, 16384: 2048}.get(n)
    if tile:
        jax_out = pk.cluster_stats(jl, jx, jy, alpha, c, tile_n=tile,
                                   sub_block=tile // 2, interpret=True)
    else:
        jax_out = pk.cluster_stats_reference(jl, jx, jy, alpha, c)
    for want in (plain, np.asarray(jax_out)):
        np.testing.assert_array_equal(got[:, :3], want[:, :3])
        np.testing.assert_allclose(got[:, 3:], want[:, 3:], **CLUSTER_TOL)
    if kind == "one":
        assert got[c - 1, 0] == n and (got[:c - 1] == 0).all()
    if kind == "none":
        assert (got == 0).all()


@pytest.mark.parametrize("n,kind,warps,chunk", [
    (2048, "random", 4, 128), (1000, "one", 2, 36), (1000, "random", 1, 8),
    (7, "random", 16, 4), (2048, "none", 8, 64)])
def test_cluster_stats_chunked_model(n, kind, warps, chunk):
    """The kernel's partition with each CTA's range walked in several
    chunks (what shared memory forces at large N or C) and fewer ranking
    warps: the ranks and the exponents carry across chunks, so the result
    still matches the plain version and the JAX oracle."""
    c, alpha = 32, 0.3
    labels, x, y = _stats_case(n, kind, c)
    got = _stats_partition_model(labels, x, y, alpha, c, warps, chunk)
    plain = ck.cluster_stats_plain(_t(labels), _t(x), _t(y), alpha, c).numpy()
    jax_out = pk.cluster_stats_reference(
        jnp.asarray(np.where(labels < c, labels, -1)), jnp.asarray(x), jnp.asarray(y), alpha, c)
    for want in (plain, np.asarray(jax_out)):
        np.testing.assert_array_equal(got[:, :3], want[:, :3])
        np.testing.assert_allclose(got[:, 3:], want[:, 3:], **CLUSTER_TOL)
    # the chunked sums reorder only the weighted f32 additions
    whole = _stats_partition_model(labels, x, y, alpha, c, warps)
    np.testing.assert_array_equal(got[:, :3], whole[:, :3])
    if kind == "one":
        assert got[c - 1, 0] == n


def _assign_model(x, y, mu, alive, radius):
    """csrc/assign_manhattan.cu: the alive means compacted in index order
    and padded to an even count with +inf, walked two at a time; a partial
    minimum over even and one over odd positions, each replaced only on a
    strict `<`, merged on (distance, position)."""
    idx = np.flatnonzero(alive)
    means = mu[idx].astype(np.float32)
    if len(idx) % 2:
        means = np.concatenate([means, np.full((1, 2), np.inf, np.float32)])
    px, py = x.astype(np.float32), y.astype(np.float32)
    inf = np.float32(np.inf)
    best = [np.full(len(x), inf), np.full(len(x), inf)]
    at = [np.full(len(x), -1), np.full(len(x), -1)]
    for p in range(0, len(means), 2):
        for par in (0, 1):
            mx, my = means[p + par]
            d = np.abs(px - mx) + np.abs(py - my)
            better = d < best[par]
            best[par] = np.where(better, d, best[par])
            at[par] = np.where(better, p + par, at[par])
    odd = (best[1] < best[0]) | ((best[1] == best[0]) & (at[1] >= 0) & (at[1] < at[0]))
    pos = np.where(odd, at[1], at[0])
    bd = np.where(odd, best[1], best[0]).astype(np.float32)
    slot = np.where(pos >= 0, idx[np.clip(pos, 0, max(len(idx) - 1, 0))] if len(idx) else 0, 0)
    return np.where(bd <= radius, slot, -1).astype(np.int32), bd


def _assign_case(kind, n=2048, c=64):
    rng = np.random.default_rng(5)
    x = rng.integers(0, 1280, n).astype(np.int32)
    y = rng.integers(0, 720, n).astype(np.int32)
    mu = (rng.random((c, 2)) * 800).astype(np.float32)
    alive = rng.random(c) > 0.5
    if kind == "ties":
        # equal means at alive slots whose compacted positions differ in
        # parity, and at two of the same parity
        alive[[10, 11, 20, 21, 22]] = True
        alive[12:20] = False
        mu[11] = mu[10]
        mu[22] = mu[20]
        x[:64], y[:64] = np.round(mu[10])
        x[64:128], y[64:128] = np.round(mu[20])
    elif kind == "dead-lower":
        alive[:8] = False
        alive[8] = True
        mu[:8] = mu[8]                 # dead lower slots on the same mean
        x[:64], y[:64] = np.round(mu[8])
    elif kind == "none":
        alive[:] = False
    elif kind == "last":
        alive[:] = False
        alive[c - 1] = True
        x[:64], y[:64] = np.round(mu[c - 1])
    elif kind == "odd":
        alive[:] = False
        alive[rng.choice(c, 7, replace=False)] = True
    return x, y, mu, alive


@pytest.mark.parametrize("kind", ["ties", "dead-lower", "none", "last", "odd", "random"])
def test_assign_compacted_model(kind):
    """The kernel's alive-compacted, unrolled argmin, modelled on the CPU,
    bit-equal to the plain version and to the JAX Pallas kernel
    (interpret): ties, dead lower-index clusters, no alive cluster, one at
    C - 1, an odd alive count."""
    x, y, mu, alive = _assign_case(kind)
    radius = 40.0
    ml, md = _assign_model(x, y, mu, alive, radius)
    pl_, pd = ck.assign_manhattan_plain(_t(x), _t(y), _t(mu), _t(alive), radius)
    kl, kd = pk.assign_manhattan(jnp.asarray(x), jnp.asarray(y), jnp.asarray(mu),
                                 jnp.asarray(alive.astype(np.int32)), radius,
                                 tile_n=1024, interpret=True)
    for wl, wd in ((pl_.numpy(), pd.numpy()), (np.asarray(kl), np.asarray(kd))):
        np.testing.assert_array_equal(ml, wl)
        np.testing.assert_array_equal(md, wd)
    if kind == "ties":
        assert (ml[:64] == 10).all() and (ml[64:128] == 20).all()
    if kind == "dead-lower":
        assert (ml[:64] == 8).all()
    if kind == "none":
        assert (ml == -1).all() and np.isinf(md).all()
    if kind == "last":
        assert (ml[:64] == len(alive) - 1).all()
