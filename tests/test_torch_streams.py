"""The adversarial input streams of the exact AEClustering engine, shared by
the CPU parity tests (test_torch_exact.py) and the card tests
(test_torch_cuda.py); this file imports no JAX. Each stream yields slices
(x, y, t, p, valid) of numpy arrays made from a seed, with its config in
STREAMS. The first four are the streams of tests/test_aeclustering.py's
engine tests; ring-full keeps the member ring full, as DEFAULT does.
"""

import numpy as np
import pytest

from evflow_tpu.config import ClusterConfig

CFG = ClusterConfig(sz_buffer=100, radius=20.0, min_n=3,
                    max_clusters=64, max_members=256)
WRAP_CFG = ClusterConfig(sz_buffer=24, radius=10.0, min_n=2,
                         max_clusters=6, max_members=32)
# a window longer than the ring: every append past M overwrites a live member
FULL_CFG = ClusterConfig(sz_buffer=64, radius=10.0, min_n=2,
                         max_clusters=8, max_members=32)


def drifting_blobs(seed=7, n_slices=5, n=200):
    """Three drifting blobs that meet (merges), 10% isolated noise
    (creations, removals), 5% invalid lanes."""
    rng = np.random.default_rng(seed)
    centers = np.array([[50., 50.], [120., 80.], [220., 40.]])
    vel = np.array([[9., 4.], [-7., 5.], [2., -3.]])
    t_base = 0
    for _ in range(n_slices):
        c = rng.integers(0, 3, n)
        xs = (centers[c, 0] + rng.normal(0, 6, n)).astype(np.int32)
        ys = (centers[c, 1] + rng.normal(0, 6, n)).astype(np.int32)
        nz = rng.random(n) < 0.1
        xs[nz] = rng.integers(0, 600, nz.sum())
        ys[nz] = rng.integers(0, 400, nz.sum())
        ts = t_base + np.sort(rng.integers(0, 1000, n)).astype(np.int32)
        ps = rng.integers(0, 2, n).astype(np.int32)
        valid = rng.random(n) < 0.95
        t_base += 1000
        centers += vel
        yield xs, ys, ts, ps, valid


def ring_wrap(seed=11):
    """More events per slice than ring rows (the ring wraps), isolated
    points that overflow the 6 cluster slots, and a blob that lives across
    the wrap."""
    rng = np.random.default_rng(seed)
    t_base = 100
    for s in range(6):
        n = 48
        xs = ((np.arange(n) * 83 + s * 17) % 500).astype(np.int32)
        ys = ((np.arange(n) * 41 + s * 29) % 300).astype(np.int32)
        xs[::4] = 250 + rng.integers(-4, 5, len(xs[::4]))
        ys[::4] = 150 + rng.integers(-4, 5, len(ys[::4]))
        ts = (t_base + np.sort(rng.integers(0, 400, n))).astype(np.int32)
        ps = rng.integers(0, 2, n).astype(np.int32)
        valid = rng.random(n) < 0.9
        t_base += 450
        yield xs, ys, ts, ps, valid


def ring_full(seed=13, n_slices=4, n=48):
    """The regime of the exact path at DEFAULT: all lanes of a slice share
    one time, so the window keeps more members than the ring holds and each
    append overwrites the live tail member. Two blobs drift into each other
    (merges); a lone point opens each slice and returns 32 events later,
    when its only member is the one being overwritten."""
    rng = np.random.default_rng(seed)
    centers = np.array([[60., 60.], [100., 60.], [300., 200.]])
    vel = np.array([[6., 0.], [-6., 0.], [0., 0.]])
    for s in range(n_slices):
        c = rng.integers(0, 2, n)
        xs = (centers[c, 0] + rng.normal(0, 3, n)).astype(np.int32)
        ys = (centers[c, 1] + rng.normal(0, 3, n)).astype(np.int32)
        xs[[0, 32]] = centers[2, 0] + np.array([0, 4])
        ys[[0, 32]] = centers[2, 1] + s
        ts = np.full(n, 1000 * (s + 1), np.int32)
        ps = rng.integers(0, 2, n).astype(np.int32)
        valid = np.ones(n, bool)
        valid[-3:] = rng.random(3) < 0.5
        centers += vel
        yield xs, ys, ts, ps, valid


def isolated_churn(seed=3, n=96):
    """Every event creates a cluster that the next one removes."""
    rng = np.random.default_rng(seed)
    xs = (np.arange(n, dtype=np.int32) * 97) % 1200
    ys = (np.arange(n, dtype=np.int32) * 53) % 700
    ts = np.sort(rng.integers(0, 5000, n)).astype(np.int32)
    yield xs, ys, ts, np.zeros(n, np.int32), np.ones(n, bool)


def empty_and_invalid(n=16):
    """An all-invalid slice, then one valid event, then all-invalid again."""
    z = np.zeros(n, np.int32)
    yield z, z, z, z, np.zeros(n, bool)
    one = np.zeros(n, bool)
    one[5] = True
    yield z + 40, z + 30, z + 1000, z, one
    yield z, z, z, z, np.zeros(n, bool)


STREAMS = {
    "drifting-blobs": (drifting_blobs, CFG),
    "ring-wrap-overflow": (ring_wrap, WRAP_CFG),
    "isolated-churn": (isolated_churn, CFG),
    "empty-and-invalid": (empty_and_invalid, CFG),
    "ring-full": (ring_full, FULL_CFG),
}


@pytest.mark.parametrize("name", list(STREAMS))
def test_stream_shapes(name):
    """Per slice: equal lengths, int32 coordinates, times sorted (the
    engine's forget assumes time order)."""
    make, _ = STREAMS[name]
    t_last = None
    for xs, ys, ts, ps, valid in make():
        assert len(xs) == len(ys) == len(ts) == len(ps) == len(valid) > 0
        assert xs.dtype == ys.dtype == ts.dtype == np.int32 and valid.dtype == bool
        assert (np.diff(ts) >= 0).all()
        if t_last is not None and valid.any():
            assert ts[valid].min() >= t_last
        if valid.any():
            t_last = ts[valid].max()
