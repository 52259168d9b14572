"""The port's exact AEClustering engine against the JAX package's.

The same numpy inputs go through JAX's `update_slice`, its Pallas kernel
`update_slice_pallas` (interpret mode, as tests/test_aeclustering.py runs
it on the CPU) and the port's `update_slice`; every AEState field must be
equal, mu included (drifting-blobs holds three three-way merges, whose
f32 sums agree). Also `update_event`, the sampling branch (kappa > 0), an
EWMA weight whose complement rounds differently in f32 and in double and
whose product is inexact, so the single rounding of JAX's fused
multiply-add shows (alpha = 0.8), `snapshot`, `membership_digest`, the
numpy oracle on the committed fixture, and an AEState handed from JAX to
the port and back.

On the ring-full stream (every append overwrites a live member, the regime
of the exact path at DEFAULT) the Pallas kernel and update_slice differ in
mu; the port follows update_slice there, and the test states the
difference.

On CPU tensors `update_slice_kernel` takes the plain version; the kernel
itself is held against it on the card in tests/test_torch_cuda.py.
"""

import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from evflow_tpu.config import ClusterConfig
from evflow_tpu.io import load_csv
from evflow_tpu.models import aeclustering as jae
from evflow_tpu.models import aeclustering_pallas as jaep
from evflow_tpu.models.aeclustering_oracle import AEClusteringOracle
from evflow_tpu_torch import interop
from evflow_tpu_torch.models import aeclustering as ae, aeclustering_kernel as aek

from test_torch_streams import CFG, STREAMS, drifting_blobs

torch.set_num_threads(2)

DATA_DIR = os.path.join(os.path.dirname(__file__), "data")
EXACT = dict(rtol=0, atol=0)


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


def _t(arrays):
    return [torch.as_tensor(a) for a in arrays]


def _run(stream, cfg, pallas=False):
    """Final (JAX state, port state) over the stream, asserting equality
    after every slice; JAX through update_slice or its Pallas kernel."""
    js, ps = jae.init_state(cfg), ae.init_state(cfg)
    for s, arrays in enumerate(stream):
        if pallas:
            js = jaep.update_slice_pallas(js, *_j(arrays), cfg, interpret=True)
        else:
            js = jae.update_slice(js, *_j(arrays), cfg)
        ps = ae.update_slice(ps, *_t(arrays), cfg)
        interop.assert_trees_close(ps, js, **EXACT, what=f"slice {s}")
    return js, ps


@pytest.mark.parametrize("name", list(STREAMS))
def test_update_slice_matches_jax(name):
    make, cfg = STREAMS[name]
    _, ps = _run(make(), cfg)
    if name == "ring-wrap-overflow":
        assert int(ps.overflow) > 0
    if name == "empty-and-invalid":
        assert bool(ps.has_t0) and int(ps.event_id) == 1
    if name == "ring-full":
        assert int((ps.mcid >= 0).sum()) == cfg.max_members
        assert int(ps.event_id) > 3 * cfg.max_members


@pytest.mark.parametrize("name", [s for s in STREAMS if s != "ring-full"])
def test_update_slice_matches_jax_pallas_kernel(name):
    make, cfg = STREAMS[name]
    _run(make(), cfg, pallas=True)


def test_pallas_kernel_differs_at_full_ring():
    """Where an append overwrites a live member, JAX's Pallas kernel
    decrements that member's cluster count before it decides is_first and
    the merge weights; update_slice, which the port follows, decides them on
    the counts before the write. From the same state, slice by slice, the
    two differ in mu only: the lone point's mean is a copy of the pixel in
    the Pallas kernel and an EWMA in update_slice."""
    make, cfg = STREAMS["ring-full"]
    js = jae.init_state(cfg)
    for s, arrays in enumerate(make()):
        jk = jaep.update_slice_pallas(js, *_j(arrays), cfg, interpret=True)
        js = jae.update_slice(js, *_j(arrays), cfg)
        differ = [f for f in js._fields
                  if not np.array_equal(np.asarray(getattr(js, f)), np.asarray(getattr(jk, f)))]
        assert differ == ["mu"], (s, differ)
        lone = int(np.argmin(np.asarray(js.corder)))    # the oldest cluster
        np.testing.assert_array_equal(np.asarray(jk.mu)[lone], [arrays[0][32], arrays[1][32]])


def merge_widths(stream, cfg):
    """How many clusters each merge of the numpy oracle joined."""
    o = AEClusteringOracle(cfg)
    widths = []
    merge = o._merge
    o._merge = lambda assigned: (widths.append(len(assigned)), merge(assigned))
    for xs, ys, ts, ps, valid in stream:
        for x, y, t, p, v in zip(xs, ys, ts, ps, valid):
            if v:
                o.update(int(x), int(y), int(t), int(p))
    return widths


def test_drifting_blobs_merge():
    """The stream really exercises merges."""
    assert len(merge_widths(drifting_blobs(), CFG)) > 0


@pytest.mark.parametrize("alpha", [0.5, 0.8])
def test_update_event_matches_jax(alpha):
    """The eager form against JAX's eager form, which rounds the EWMA twice;
    at alpha = 0.5 it also equals the slice form (one FMA, see
    test_configs_match_jax), since both of its products are exact there."""
    cfg = ClusterConfig(sz_buffer=48, radius=12.0, min_n=2, alpha=alpha,
                        max_clusters=12, max_members=64)
    rng = np.random.default_rng(5)
    js, ps = jae.init_state(cfg), ae.init_state(cfg)
    for i in range(150):
        x, y = (int(v) for v in rng.integers(0, 100, 2))
        t, p = 1000 + 7 * i, i % 2
        js = jae.update_event(js, jnp.int32(x), jnp.int32(y), jnp.int32(t),
                              jnp.int32(p), cfg)
        ps = ae.update_event(ps, x, y, t, p, cfg)
        if i % 25 == 24:
            interop.assert_trees_close(ps, js, **EXACT, what=f"event {i}")
    interop.assert_trees_close(ps, js, **EXACT)
    assert int(ps.next_cid) > 1 and int(ps.event_id) > 0
    if alpha != 0.5:
        return
    # the slice form equals the eager one on the same events
    sl = ae.init_state(cfg)
    rng = np.random.default_rng(5)
    pts = np.array([rng.integers(0, 100, 2) for _ in range(150)], np.int32)
    ts = (1000 + 7 * np.arange(150)).astype(np.int32)
    sl = ae.update_slice(sl, *_t((pts[:, 0], pts[:, 1], ts,
                                  (np.arange(150) % 2).astype(np.int32),
                                  np.ones(150, bool))), cfg)
    for f in ("alive", "corder", "cid", "mu", "mcid", "mx", "my", "mt", "thead",
              "next_order", "next_cid", "event_id", "overflow", "t0"):
        assert torch.equal(getattr(sl, f), getattr(ps, f)), f


@pytest.mark.parametrize("cfg", [
    ClusterConfig(sz_buffer=100, radius=20.0, min_n=3, kappa=2,
                  max_clusters=64, max_members=256),
    ClusterConfig(sz_buffer=100, radius=20.0, min_n=3, alpha=0.8,
                  max_clusters=64, max_members=256),
], ids=["kappa2", "alpha0.8"])
def test_configs_match_jax(cfg):
    if cfg.alpha == 0.8:
        # the plain version's f32(1 - alpha) is not f32(1) - f32(alpha)
        assert np.float32(1.0 - 0.8) != np.float32(1) - np.float32(0.8)
    js, ps = _run(drifting_blobs(seed=2), cfg)
    # the kernel wrapper on CPU tensors is the plain version
    ks = ae.init_state(cfg)
    for arrays in drifting_blobs(seed=2):
        ks = aek.update_slice_kernel(ks, *_t(arrays), cfg)
    interop.assert_trees_close(ks, ps, **EXACT)


def test_snapshot_and_digest_match_jax():
    js, ps = _run(drifting_blobs(seed=4, n_slices=3), CFG)
    interop.assert_trees_close(ae.snapshot(ps, CFG), jae.snapshot(js, CFG), **EXACT)
    np.testing.assert_array_equal(ae.membership_digest(ps, CFG).numpy(),
                                  np.asarray(jae.membership_digest(js, CFG)))
    view = ae.snapshot(ps, CFG)
    assert int(view.n.sum()) > 0 and bool(view.alive.any())


def test_fixture_csv_matches_oracle():
    """The committed 320-event fixture: clusters keyed by deque order match
    the numpy transliteration of the reference."""
    s = load_csv(os.path.join(DATA_DIR, "event_raw_data8.csv"))
    cfg = ClusterConfig(sz_buffer=100, radius=20.0, min_n=5,
                        max_clusters=128, max_members=256)
    n = len(s.x)
    st = ae.update_slice(ae.init_state(cfg), *_t((s.x.astype(np.int32), s.y.astype(np.int32),
                                                  s.t.astype(np.int32), s.p.astype(np.int32),
                                                  np.ones(n, bool))), cfg)
    view = ae.snapshot(st, cfg)
    o = AEClusteringOracle(cfg)
    for x, y, t, p in zip(s.x, s.y, s.t, s.p):
        o.update(int(x), int(y), int(t), int(p))
    alive = view.alive.numpy()
    perm = np.argsort(view.order.numpy()[alive])
    got = [(int(view.cid[alive][i]), int(view.n[alive][i]),
            view.mu.numpy()[alive][i], view.centroid.numpy()[alive][i]) for i in perm]
    got = [g for g in got if g[1] > 0]
    exp = [e for e in o.live_stats() if e[1] > 0]
    assert len(got) == len(exp) > 0
    for g, e in zip(got, exp):
        assert g[0] == e[0] and g[1] == e[1], (g, e)
        np.testing.assert_allclose(g[2], e[2], atol=1e-2)
        np.testing.assert_allclose(g[3], e[3], atol=1e-2)


def test_state_round_trips_through_interop():
    """JAX state -> port -> JAX, and a port run resumed from a JAX state
    continues like JAX."""
    streams = list(drifting_blobs(seed=9, n_slices=4))
    js = jae.init_state(CFG)
    for arrays in streams[:2]:
        js = jae.update_slice(js, *_j(arrays), CFG)
    ps = interop.from_jax(ae.init_state(CFG), js)
    interop.assert_trees_close(ps, js, **EXACT)
    treedef = jax.tree_util.tree_structure(js)
    back = jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(a) for a in interop.to_leaves(ps)])
    interop.assert_trees_close(back, js, **EXACT)
    for arrays in streams[2:]:
        js = jae.update_slice(js, *_j(arrays), CFG)
        ps = ae.update_slice(ps, *_t(arrays), CFG)
    interop.assert_trees_close(ps, js, **EXACT)
