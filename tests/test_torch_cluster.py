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
    st_t = fastcluster.init_state(cfg)
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
    state = fastcluster.init_state(cfg.cluster)
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
    st_j, st_t = jtracker.init_state(cfg), tracker.init_state(cfg)
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
