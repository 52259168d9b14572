"""The port's snapshot-stack q > 1 corner path (`micro_stack=True`) against
the JAX package's stack path and the port's own serial micro path, and
`efast.detect_corners_stacked` against JAX's and per-snapshot detection.

Tolerances: the port's stack path gives the same bits as its serial path,
every state and output leaf (rtol 0, atol 0). Against JAX, integer and
bool leaves (the SAE, counts, labels, masks) are equal and the tracker's
floats within test_torch_pipeline.py's rtol 1e-5 / atol 1e-4 (the port's
tracker is not bit-equal to JAX's on any path); `full_scan`'s cluster
floats within rtol 1e-5 / atol 1e-3."""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from evflow_tpu.config import (EFastConfig, EngineConfig, NMSConfig, SensorConfig,
                               SliceConfig, TrackerConfig)
from evflow_tpu.models import pipeline as jp
from evflow_tpu.ops import efast as jefast, sae as jsae
from evflow_tpu_torch import fidelity, interop
from evflow_tpu_torch.models import pipeline
from evflow_tpu_torch.ops import efast

from test_torch_pipeline import CFG as SCAN_CFG, _jax_full_scan, _port_full_scan, _slices

torch.set_num_threads(2)

EXACT = dict(rtol=0, atol=0)
TRACK_TOL = dict(rtol=1e-5, atol=1e-4)
W = H = 128
CFG = EngineConfig(
    sensor=SensorConfig(width=W, height=H),
    slicing=SliceConfig(n_events=1024),
    tracker=TrackerConfig(max_tracks=32, history=6, frames_to_skip=3,
                          max_frames=30, group_radius=60.0),
    nms=NMSConfig(max_corners=64),
)


def _wedge_slice(cx, cy, t0, n=1024, seed=0):
    """A filled wedge with its apex at (cx, cy), painted in time order."""
    rng = np.random.default_rng(seed)
    x = rng.integers(max(0, cx - 40), cx + 1, n).astype(np.int32)
    y = rng.integers(max(0, cy - 40), cy + 1, n).astype(np.int32)
    t = (t0 + np.sort(rng.integers(0, 900, n))).astype(np.int32)
    return x, y, t


def _cfg(q, stack, **kw):
    return dataclasses.replace(CFG, efast=dataclasses.replace(
        CFG.efast, micro_slices=q, max_candidates=1024, micro_stack=stack, **kw))


@pytest.mark.parametrize("q", [4, 8])
def test_stack_matches_jax_and_serial(q):
    """Five wedge slices, the fourth partly invalid: the port's stack path
    equals JAX's stack path and the port's serial path, every state and
    output leaf, every slice."""
    stack, serial = _cfg(q, True), _cfg(q, False)
    jst = jp.init_corner_state(stack)
    pst = pipeline.init_corner_state(stack, device="cpu")
    sst = pipeline.init_corner_state(serial, device="cpu")
    cx, cy = 50, 50
    corners = 0
    for s in range(5):
        x, y, t = _wedge_slice(cx, cy, 1000 * (s + 1), seed=s)
        v = np.ones(len(x), bool)
        if s == 3:
            v[700:] = False
        jst, jout = jp.corner_track_step(jst, *[jnp.asarray(a) for a in (x, y, t, v)], stack)
        args = [torch.as_tensor(a) for a in (x, y, t, v)]
        pst, pout = pipeline.corner_track_step(pst, *args, stack)
        sst, sout = pipeline.corner_track_step(sst, *args, serial)
        interop.assert_trees_close((pst, pout), (jst, jout), **TRACK_TOL,
                                   what=f"q={q} s={s} jax")
        interop.assert_trees_close((pst, pout), (sst, sout), **EXACT, what=f"q={q} s={s} serial")
        corners += int(pout.num_corners)
        cx += 6
    assert corners > 0


def test_stack_drops_out_of_range_and_lifts_negative_times():
    """Lanes with x at the width or a negative y wrap or drop as JAX's
    mode="drop" does, and the planes start at 0 as in JAX, so a negative
    time in the input surface comes out as 0."""
    cfg = _cfg(4, True)
    x, y, t = _wedge_slice(60, 60, 5000, seed=9)
    x[:8] = W
    y[8:16] = -3
    v = np.ones(len(x), bool)
    jst = jp.init_corner_state(cfg)
    jst = jst._replace(sae=jst.sae.at[0, :5].set(-7))
    pst = interop.from_jax(pipeline.init_corner_state(cfg, device="cpu"), jst)
    jst, jout = jp.corner_track_step(jst, *[jnp.asarray(a) for a in (x, y, t, v)], cfg)
    pst, pout = pipeline.corner_track_step(pst, *[torch.as_tensor(a) for a in (x, y, t, v)],
                                           cfg)
    interop.assert_trees_close((pst, pout), (jst, jout), **TRACK_TOL)
    assert int(pst.sae[0, :5].min()) == 0


def test_full_scan_stack_q8_matches_jax():
    cfg = dataclasses.replace(SCAN_CFG, efast=dataclasses.replace(
        SCAN_CFG.efast, micro_slices=8, micro_stack=True))
    arrays = _slices(6, seed=7)
    (gcl, gco), (gclo, gcoo) = _port_full_scan(arrays, cfg)
    (wcl, wco), (wclo, wcoo) = _jax_full_scan(arrays, cfg)
    interop.assert_trees_close((gcl, gclo), (wcl, wclo), rtol=1e-5, atol=1e-3, what="cluster")
    interop.assert_trees_close((gco, gcoo), (wco, wcoo), **TRACK_TOL, what="corner")
    assert int(gcoo.num_corners[0]) == 0 and int(gcoo.num_corners[1:].min()) > 0


def _snapshots(q=4, m=64, seed=9):
    """q SAE snapshots of a moving wedge with noise, and q sets of m
    candidates, half of them near the wedge's apex (as the JAX test)."""
    rng = np.random.default_rng(seed)
    sensor = SensorConfig(width=160, height=96)
    sae = jnp.zeros((sensor.height, sensor.width), jnp.int32)
    saes, xs, ys, vs = [], [], [], []
    t0 = 100
    for k in range(q):
        n = 500
        cx = 40 + 6 * k
        x = rng.integers(max(0, cx - 30), cx + 1, n).astype(np.int32)
        y = rng.integers(10, 41, n).astype(np.int32)
        nz = rng.random(n) < 0.2
        x[nz] = rng.integers(0, sensor.width, nz.sum())
        y[nz] = rng.integers(0, sensor.height, nz.sum())
        t = (t0 + np.sort(rng.integers(0, 90, n))).astype(np.int32)
        sae = jsae.update_sae(sae, jnp.asarray(x), jnp.asarray(y), jnp.asarray(t),
                              jnp.ones(n, bool))
        saes.append(np.asarray(sae))
        ccx = rng.integers(0, sensor.width, m).astype(np.int32)
        ccy = rng.integers(0, sensor.height, m).astype(np.int32)
        ccx[: m // 2] = np.clip(cx + rng.integers(-2, 3, m // 2), 0, sensor.width - 1)
        ccy[: m // 2] = np.clip(40 + rng.integers(-2, 3, m // 2), 0, sensor.height - 1)
        xs.append(ccx)
        ys.append(ccy)
        vs.append(rng.random(m) < 0.9)
        t0 += 100
    return sensor, [np.stack(a) for a in (saes, xs, ys, vs)]


@pytest.mark.parametrize("axis_order", [True, False])
def test_detect_corners_stacked(axis_order):
    """Equal to JAX's detect_corners_stacked and to per-snapshot
    detect_corners, bit for bit."""
    sensor, (saes, xs, ys, vs) = _snapshots()
    cfg = EFastConfig(group_track_axis_order=axis_order)
    got = efast.detect_corners_stacked(*[torch.as_tensor(a) for a in (saes, xs, ys, vs)],
                                       cfg, sensor)
    want = jefast.detect_corners_stacked(*[jnp.asarray(a) for a in (saes, xs, ys, vs)],
                                         cfg, sensor)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    per_sub = torch.stack([efast.detect_corners(torch.as_tensor(saes[k]),
                                                torch.as_tensor(xs[k]), torch.as_tensor(ys[k]),
                                                torch.as_tensor(vs[k]), cfg, sensor)
                           for k in range(len(saes))])
    assert torch.equal(got, per_sub)
    assert int(got.sum()) > 0


def test_stack_corner_agreement_equals_jax():
    """The stack detector's corner agreement with per-event-exact detection
    is the JAX package's q=8 value (the serial micro path's, which the
    stack path equals)."""
    assert fidelity.corner_agreement(8, device="cpu", stack=True) == fidelity.JAX_AGREEMENT[8]
