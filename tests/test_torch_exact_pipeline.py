"""The port's exact cluster+flow path, q>1 micro-slice corner path and
per-event-exact detector against the JAX package.

- `cluster_flow_scan_exact` and `ClusterFlowPipeline(mode="exact").run`,
  with the small CFG of test_torch_pipeline.py, with compat_fabricated_ts
  and with exact_block=16 (JAX takes its blocked engine there, the port its
  one engine: the two are bit-equal);
- a resume split mid-stream and a JAX -> port state handover, both equal to
  an unbroken JAX run;
- `full_scan` at q=8, serial and micro_dense, and the shapes on which q>1
  falls back to the q=1 path (N % q != 0, no candidate cap);
- `event_exact_corner_mask` on bench.py's wedge scene, and the corner
  agreement of `evflow_tpu_torch.fidelity` against bench.py's
  `measure_agreement` run on the same scene.

Tolerances: the exact path's outputs are all exact here (integer fields and
the engine's f32 state by construction; centroids are integer sums over
integer counts); full_scan as in test_torch_pipeline.py.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import bench
from evflow_tpu.config import ClusterConfig, DedupConfig
from evflow_tpu.models import pipeline as jp
from evflow_tpu_torch import fidelity, interop
from evflow_tpu_torch.models import aeclustering as ae, pipeline

from test_torch_pipeline import (CFG, N, _assert_scan_close, _jax_full_scan,
                                       _port_full_scan, _scene, _slices)

torch.set_num_threads(2)

EXACT = dict(rtol=0, atol=0)
# the exact engine's scene: clusters need the blobs, 32 slots fit them
EXACT_CFG = dataclasses.replace(
    CFG, cluster=ClusterConfig(sz_buffer=400, radius=20.0, min_n=5,
                               max_clusters=32, max_members=1024))


def _cluster(**kw):
    return dataclasses.replace(EXACT_CFG, cluster=dataclasses.replace(
        EXACT_CFG.cluster, **kw))


def _dedup(**kw):
    return dataclasses.replace(EXACT_CFG, dedup=DedupConfig(**kw))


def _efast(**kw):
    return dataclasses.replace(CFG, efast=dataclasses.replace(CFG.efast, **kw))


def _jax_exact_state(cfg):
    return jp.ClusterFlowPipeline(cfg, mode="exact").init_state()


def _port_exact_state(cfg):
    return pipeline.ClusterFlowPipeline(cfg, mode="exact").init_state()


@pytest.mark.parametrize("cfg", [
    EXACT_CFG,
    _dedup(compat_fabricated_ts=True),
    _cluster(exact_block=16),
], ids=["default", "fabricated-ts", "exact-block16"])
def test_exact_scan_matches_jax(cfg):
    x, y, t, v = _slices(4, seed=6)
    want = jp.cluster_flow_scan_exact(_jax_exact_state(cfg), jnp.asarray(x),
                                      jnp.asarray(y), jnp.asarray(t),
                                      jnp.asarray(v), cfg)
    got = pipeline.cluster_flow_scan_exact(_port_exact_state(cfg),
                                           *[torch.as_tensor(a) for a in (x, y, t, v)],
                                           cfg)
    interop.assert_trees_close(got, want, **EXACT)
    (_, _, _, _), outs = got
    assert bool(outs.reported.any(1).all())
    assert float(outs.flow.abs().max()) > 0


def test_exact_pipeline_run_matches_jax():
    stream = _scene(5, seed=3)
    jpipe = jp.ClusterFlowPipeline(EXACT_CFG, mode="exact")
    ppipe = pipeline.ClusterFlowPipeline(EXACT_CFG, mode="exact")
    want, got = jpipe.run(stream), ppipe.run(stream)
    assert len(got) == len(want) == 5
    for s in range(5):
        interop.assert_trees_close(got[s], want[s], **EXACT, what=f"slice {s}")
    interop.assert_trees_close(ppipe.final_state, jpipe.final_state, **EXACT)
    assert ppipe.t0 == jpipe.t0 == int(stream.t[0])


def test_exact_resume_split_matches_unbroken_jax():
    """Port run on the first part, then resumed from its final state and t0
    on the rest: equal to one unbroken JAX run; and a JAX state handed to
    the port mid-stream continues like JAX."""
    cfg = EXACT_CFG
    stream = _scene(5, seed=8)
    jfull = jp.ClusterFlowPipeline(cfg, mode="exact")
    want = jfull.run(stream)

    cut = 2 * N
    first = pipeline.ClusterFlowPipeline(cfg, mode="exact")
    head = first.run(stream[:cut])
    second = pipeline.ClusterFlowPipeline(cfg, mode="exact")
    tail = second.run(stream[cut:], state=first.final_state, t0=first.t0)
    assert second.t0 == int(stream.t[0])
    for s, (g, w) in enumerate(zip(head + tail, want)):
        interop.assert_trees_close(g, w, **EXACT, what=f"split slice {s}")

    jhead = jp.ClusterFlowPipeline(cfg, mode="exact")
    jhead.run(stream[:cut])
    handed = interop.from_jax(_port_exact_state(cfg), jhead.final_state)
    third = pipeline.ClusterFlowPipeline(cfg, mode="exact")
    tail = third.run(stream[cut:], state=handed, t0=jhead.t0)
    for s, (g, w) in enumerate(zip(tail, want[2:])):
        interop.assert_trees_close(g, w, **EXACT, what=f"handover slice {s + 2}")
    interop.assert_trees_close(third.final_state, jfull.final_state, **EXACT)


def test_exact_step_engines_agree():
    """exact_pallas off (the plain update_slice) and on (the kernel wrapper,
    its plain version on the CPU) give the same step."""
    x, y, t, v = [torch.as_tensor(a[0]) for a in _slices(1, seed=2)]
    st = ae.init_state(EXACT_CFG.cluster)
    a = pipeline.cluster_flow_step_exact(st, x, y, t, v, EXACT_CFG)
    b = pipeline.cluster_flow_step_exact(st, x, y, t, v, _cluster(exact_pallas=False))
    interop.assert_trees_close(a, b, **EXACT)
    assert int(a[0].next_cid) > 0


@pytest.mark.parametrize("cfg", [
    _efast(micro_slices=8),
    _efast(micro_slices=8, micro_dense=True),
], ids=["serial", "micro-dense"])
def test_q8_full_scan_matches_jax(cfg):
    arrays = _slices(5)
    got = _port_full_scan(arrays, cfg)
    _assert_scan_close(got, _jax_full_scan(arrays, cfg))
    (_, _), (_, coo) = got
    assert int(coo.num_corners[0]) == 0 and int(coo.num_corners[1:].min()) > 0


@pytest.mark.parametrize("n, cap", [(N - 4, 512), (N, 0)],
                         ids=["ragged-slice", "no-candidate-cap"])
def test_q8_falls_back_like_jax(n, cap):
    """q > 1 runs the micro path only when N % q == 0 and a candidate cap is
    set; otherwise both packages take the q = 1 path."""
    cfg = _efast(micro_slices=8, max_candidates=cap)
    x, y, t, v = [a[:, :n] for a in _slices(3, seed=4)]
    want = jp.corner_track_scan(jp.init_corner_state(cfg), *[jnp.asarray(a) for a in
                                                             (x, y, t, v)], cfg)
    got = pipeline.corner_track_scan(pipeline.init_corner_state(cfg),
                                     *[torch.as_tensor(a) for a in (x, y, t, v)], cfg)
    interop.assert_trees_close(got, want, rtol=1e-5, atol=1e-4)
    assert int(got[1].num_corners[1:].min()) > 0


def test_event_exact_matches_jax_on_wedge_scene():
    """bench.py's wedge scene, slices 0-3: mask and surface equal, and the
    event-exact corner step equal, for both ring axis orders."""
    for axis in (True, False):
        cfg = dataclasses.replace(CFG, efast=dataclasses.replace(
            CFG.efast, group_track_axis_order=axis))
        js, ps = jp.init_corner_state(cfg), pipeline.init_corner_state(cfg)
        sae_j = jnp.zeros((CFG.sensor.height, CFG.sensor.width), jnp.int32)
        sae_p = torch.zeros((CFG.sensor.height, CFG.sensor.width), dtype=torch.int32)
        cx, cy, corners = 50, 50, 0
        for s in range(4):
            x, y, t = fidelity.wedge(cx, cy, 1000 * (s + 1), n=N, seed=s)
            x[:3] = (0, 255, 3)          # border events: masked, patch clamped
            y[:3] = (0, 119, 117)
            v = np.ones(N, bool)
            v[7] = False
            sae_j, mj = jp.event_exact_corner_mask(sae_j, *[jnp.asarray(a) for a in
                                                            (x, y, t, v)],
                                                   jnp.bool_(s > 0), cfg)
            sae_p, mp = pipeline.event_exact_corner_mask(
                sae_p, *[torch.as_tensor(a) for a in (x, y, t, v)], s > 0, cfg)
            np.testing.assert_array_equal(mp.numpy(), np.asarray(mj), err_msg=f"{s}")
            np.testing.assert_array_equal(sae_p.numpy(), np.asarray(sae_j))
            js, jo = jp.corner_track_step_event_exact(
                js, *[jnp.asarray(a) for a in (x, y, t, v)], cfg)
            ps, po = pipeline.corner_track_step_event_exact(
                ps, *[torch.as_tensor(a) for a in (x, y, t, v)], cfg)
            interop.assert_trees_close((ps, po), (js, jo), rtol=1e-5, atol=1e-4)
            corners += int(mp.sum())
            cx += 6
        assert corners > 0


@pytest.mark.parametrize("q", [8, 1])
def test_corner_agreement_matches_jax(q):
    """The port's corner agreement equals the JAX package's, measured here
    by bench.py:measure_agreement on the same scene; fidelity.JAX_AGREEMENT,
    which chip_smoke.py prints beside the port's value, is that value."""
    want = bench.measure_agreement(q)
    assert fidelity.JAX_AGREEMENT[q] == want
    assert fidelity.corner_agreement(q) == want
