"""The PyTorch port's whole slice against the JAX package: `full_scan` (both
chains), the two pipelines' `run` loops, a cross-framework resume through
`interop`, the representative-candidate compaction, and the rule that the
port imports no JAX. Small sensor and slices; a scene of moving wedges
(persistent eFAST corners) and gaussian blobs (clusters).

Tolerances as in test_torch_cluster.py: discrete fields exact, cluster
floats rtol 1e-5 / atol 1e-3, tracker floats rtol 1e-5 / atol 1e-4."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from evflow_tpu.config import (DEFAULT, ClusterConfig, NMSConfig, SensorConfig,
                               SliceConfig, TrackerConfig)
from evflow_tpu.io import EventStream, slice_by_count
from evflow_tpu.models import fastcluster as jfc, pipeline as jp
from evflow_tpu_torch import interop
from evflow_tpu_torch.models import fastcluster, pipeline

torch.set_num_threads(2)

CLUSTER_TOL = dict(rtol=1e-5, atol=1e-3)
TRACK_TOL = dict(rtol=1e-5, atol=1e-4)
N = 1024
CFG = dataclasses.replace(
    DEFAULT, sensor=SensorConfig(width=256, height=120),
    slicing=SliceConfig(n_events=N),
    efast=dataclasses.replace(DEFAULT.efast, max_candidates=512),
    nms=NMSConfig(max_corners=128), tracker=TrackerConfig(max_tracks=64),
    cluster=ClusterConfig(max_clusters=32))


def _scene(num_slices, n=N, width=256, height=120, seed=0) -> EventStream:
    """Filled wedges painted pixel by pixel (their apexes are eFAST corners)
    drifting right, plus two gaussian blobs, in time order."""
    rng = np.random.default_rng(seed)
    xs, ys, ts = [], [], []
    for s in range(num_slices):
        px, py = [], []
        for ax, ay in ((40 + 2 * s, 40), (150 + s, 90), (200 - s, 30)):
            gx, gy = np.meshgrid(np.arange(ax - 8, ax + 1), np.arange(ay - 8, ay + 1))
            px.append(gx.ravel())
            py.append(gy.ravel())
        rest = n - sum(len(p) for p in px)
        for (bx, by), nb in zip(((80 + 3 * s, 70), (190 - 2 * s, 60)),
                                (rest // 2, rest - rest // 2)):
            px.append(np.clip(rng.normal(bx, 4.0, nb), 0, width - 1))
            py.append(np.clip(rng.normal(by, 4.0, nb), 0, height - 1))
        x = np.concatenate(px).astype(np.int32)
        y = np.concatenate(py).astype(np.int32)
        perm = rng.permutation(len(x))
        xs.append(x[perm])
        ys.append(y[perm])
        ts.append(1000 * (s + 1) + np.sort(rng.integers(0, 900, len(x))))
    t = np.concatenate(ts).astype(np.int64)
    return EventStream(np.concatenate(xs), np.concatenate(ys), t,
                       np.zeros(len(t), np.int32))


def _slices(num_slices, seed=0):
    stream = _scene(num_slices, seed=seed)
    sl = slice_by_count(stream, N, drop_partial=True)
    ts = (sl.t - int(stream.t[0])).astype(np.int32)
    return sl.x, sl.y, ts, sl.valid_mask()


def _jax_full_scan(arrays, cfg=CFG, states=None):
    cl, co = states or (jfc.init_state(cfg.cluster), jp.init_corner_state(cfg))
    return jp.full_scan(cl, co, *[jnp.asarray(a) for a in arrays], cfg)


def _port_full_scan(arrays, cfg=CFG, states=None, device="cpu"):
    cl, co = states or (fastcluster.init_state(cfg.cluster, device=device),
                        pipeline.init_corner_state(cfg, device=device))
    return pipeline.full_scan(cl, co, *[torch.as_tensor(a, device=device)
                                        for a in arrays], cfg)


def _assert_scan_close(got, want, what=""):
    (gcl, gco), (gclo, gcoo) = got
    (wcl, wco), (wclo, wcoo) = want
    interop.assert_trees_close((gcl, gclo), (wcl, wclo), **CLUSTER_TOL,
                               what=what + " cluster")
    interop.assert_trees_close((gco, gcoo), (wco, wcoo), **TRACK_TOL,
                               what=what + " corner")


def _efast(**kw):
    return dataclasses.replace(CFG, efast=dataclasses.replace(CFG.efast, **kw))


@pytest.mark.parametrize("cfg", [
    CFG,                               # candidates + dense stencil (main path)
    _efast(dense_detect=False),        # candidates + per-candidate gather
    _efast(max_candidates=N),          # no candidate cap: every event tested
], ids=["dense", "gather", "all-events"])
def test_full_scan_matches_jax(cfg):
    arrays = _slices(8)
    got = _port_full_scan(arrays, cfg)
    _assert_scan_close(got, _jax_full_scan(arrays, cfg))
    (_, _), (clo, coo) = got
    assert int(coo.num_corners[0]) == 0 and int(coo.num_corners[1:].min()) > 0
    assert int(coo.num_filtered.sum()) > 0 and int(coo.track_active[-1].sum()) > 0
    assert bool(clo.reported.any(1).all())


def test_full_scan_matches_separate_scans():
    arrays = [torch.as_tensor(a) for a in _slices(4, seed=5)]
    (cl, co), (clo, coo) = pipeline.full_scan(
        fastcluster.init_state(CFG.cluster), pipeline.init_corner_state(CFG),
        *arrays, CFG)
    xs, ys, ts, vs = arrays
    exact = dict(rtol=0, atol=0)
    interop.assert_trees_close(
        (cl, clo), pipeline.cluster_flow_scan(fastcluster.init_state(CFG.cluster),
                                              xs, ys, vs, CFG), **exact)
    interop.assert_trees_close(
        (co, coo), pipeline.corner_track_scan(pipeline.init_corner_state(CFG),
                                              xs, ys, ts, vs, CFG), **exact)


def test_resume_from_jax_state():
    """k slices in JAX, the state handed over, the rest in the port: equal
    to an all-JAX run, state and outputs; and the port's final state handed
    back to JAX continues like the JAX one."""
    arrays = _slices(7, seed=1)
    k = 3
    head = [a[:k] for a in arrays]
    tail = [a[k:] for a in arrays]
    (jcl, jco), _ = _jax_full_scan(head)
    want = _jax_full_scan(tail, states=(jcl, jco))
    templates = (fastcluster.init_state(CFG.cluster), pipeline.init_corner_state(CFG))
    cl, co = interop.from_jax(templates, (jcl, jco))
    got = _port_full_scan(tail, states=(cl, co))
    _assert_scan_close(got, want, "resumed")

    (pcl, pco), _ = got
    treedef = jax.tree_util.tree_structure(want[0])
    back = jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(a) for a in interop.to_leaves((pcl, pco))])
    extra = _slices(2, seed=2)
    _assert_scan_close(_port_full_scan(extra, states=(pcl, pco)),
                       _jax_full_scan(extra, states=back), "handed back")


def test_interop_checks_leaves():
    cl = fastcluster.init_state(CFG.cluster)
    leaves = interop.to_leaves(cl)
    with pytest.raises(ValueError):
        interop.from_leaves(cl, leaves[:-1] + [leaves[-1].astype(np.int64)])
    with pytest.raises(ValueError):
        interop.from_leaves(cl, leaves + [leaves[0]])


def test_pipelines_run_like_jax():
    stream = _scene(5, seed=3)
    jc = jp.ClusterFlowPipeline(CFG).run(stream)
    tc = pipeline.ClusterFlowPipeline(CFG).run(stream)
    jt = jp.CornerTrackPipeline(CFG).run(stream)
    tt = pipeline.CornerTrackPipeline(CFG).run(stream)
    assert len(jc) == len(tc) == len(jt) == len(tt) == 5
    for s in range(5):
        interop.assert_trees_close(tc[s], jc[s], **CLUSTER_TOL, what=f"cluster {s}")
        interop.assert_trees_close(tt[s], jt[s], **TRACK_TOL, what=f"corner {s}")


def test_representative_candidates_oracle():
    """The last valid lane of each touched pixel, compacted in stream order
    of that lane, overflow beyond the budget dropped from the tail and
    counted; and the same lanes as JAX's two-sort form."""
    rng = np.random.default_rng(3)
    n, m = 512, 64
    px = rng.integers(0, 40, n).astype(np.int32)
    py = rng.integers(0, 30, n).astype(np.int32)
    t = np.sort(rng.integers(0, 200, n)).astype(np.int32)
    valid = rng.random(n) < 0.85
    last = {}
    for i in range(n):
        if valid[i]:
            last[(int(px[i]), int(py[i]))] = i
    lanes = sorted(last.values())
    exp = [(int(px[i]), int(py[i])) for i in lanes][:m]
    cx, cy, cv, nd = pipeline._representative_candidates(
        torch.as_tensor(px), torch.as_tensor(py), torch.as_tensor(valid), m, DEFAULT)
    got = [(int(a), int(b)) for a, b, ok in zip(cx, cy, cv) if ok]
    assert got == exp
    assert int(nd) == max(len(lanes) - m, 0)
    want = jp._representative_candidates(None, jnp.asarray(px), jnp.asarray(py),
                                         jnp.asarray(t), jnp.asarray(valid), m, DEFAULT)
    for g, w in zip((cx, cy, cv, nd), want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_compat_stride2_matches_jax():
    cfg = dataclasses.replace(CFG, dedup=dataclasses.replace(CFG.dedup,
                                                             compat_stride2=True))
    x, y, _, v = [a[:3] for a in _slices(3, seed=4)]
    jst, tst = jfc.init_state(cfg.cluster), fastcluster.init_state(cfg.cluster)
    for s in range(3):
        jst, jo = jp.cluster_flow_step(jst, jnp.asarray(x[s]), jnp.asarray(y[s]),
                                       jnp.asarray(v[s]), cfg)
        tst, to = pipeline.cluster_flow_step(tst, torch.as_tensor(x[s]),
                                             torch.as_tensor(y[s]),
                                             torch.as_tensor(v[s]), cfg)
        interop.assert_trees_close((tst, to), (jst, jo), **CLUSTER_TOL)


def test_unported_branches_raise():
    """The snapshot-stack q>1 backend is not ported; micro_dense takes
    precedence over it, as in JAX."""
    stack = dataclasses.replace(CFG, efast=dataclasses.replace(
        CFG.efast, micro_slices=8, micro_stack=True))
    x, y, t, v = [torch.as_tensor(a[0]) for a in _slices(1)]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        pipeline.corner_track_step(pipeline.init_corner_state(stack), x, y, t, v, stack)
    dense = dataclasses.replace(stack, efast=dataclasses.replace(stack.efast,
                                                                 micro_dense=True))
    pipeline.corner_track_step(pipeline.init_corner_state(dense), x, y, t, v, dense)


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import evflow_tpu_torch\n"
        "for m in pkgutil.walk_packages(evflow_tpu_torch.__path__, 'evflow_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "assert 'jax' not in sys.modules, sorted(k for k in sys.modules if 'jax' in k)\n"
        "print(len([m for m in sys.modules if m.startswith('evflow_tpu_torch')]))\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       cwd=root, env=env, timeout=300)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.strip()) >= 12
