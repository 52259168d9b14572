"""The fast-corner-tracker evolution chain through the port's tracker (the
counterpart of tests/test_tracker_evolution.py): each intermediate stage
#4-#7 of the reference's lineage is a TrackerConfig setting, the final
stage #8 the default. Each stage's state is also held against the JAX
tracker's on the same detections: integer and bool fields equal, floats
within rtol 1e-5, atol 1e-4 (the order of norms and small sums).
"""

import numpy as np
import torch
import jax.numpy as jnp

from evflow_tpu.config import TrackerConfig as JTrackerConfig
from evflow_tpu.models import tracker as jtrk
from evflow_tpu_torch import interop
from evflow_tpu_torch.config import TrackerConfig
from evflow_tpu_torch.models import tracker as trk

D = 8
TOL = dict(rtol=1e-5, atol=1e-4)


def _dets(dets):
    xs = np.zeros(D, np.float32)
    ys = np.zeros(D, np.float32)
    valid = np.zeros(D, bool)
    for i, (x, y) in enumerate(dets):
        xs[i], ys[i], valid[i] = x, y, True
    return xs, ys, valid


def _run(cfg, frames, state=None):
    """The port's tracker over `frames`, each step held against JAX's."""
    jcfg = JTrackerConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})
    if state is None:
        state = trk.init_state(cfg, device="cpu")
    jstate = jtrk.init_state(jcfg)
    jstate = type(jstate)(*[jnp.asarray(a) for a in interop.to_leaves(state)])
    groups = None
    for dets in frames:
        xs, ys, valid = _dets(dets)
        state, groups = trk.update(state, torch.as_tensor(xs), torch.as_tensor(ys),
                                   torch.as_tensor(valid), cfg)
        jstate, jgroups = jtrk.update(jstate, jnp.asarray(xs), jnp.asarray(ys),
                                      jnp.asarray(valid), jcfg)
        interop.assert_trees_close((state, groups), (jstate, jgroups), **TOL)
    return state, groups


FRAMES = [[(100 + 5 * k, 100), (120 + 5 * k, 108)] for k in range(6)]


def test_stage4_label_persistence_only():
    """#4 periodic_corner: nearest-neighbor label persistence, no history,
    velocity, damping or groups."""
    cfg = TrackerConfig(max_tracks=16, history=1, frames_to_skip=0,
                        damping=0.0, smoothing=0.0, group_radius=0.0,
                        max_distance=30.0, max_frames=100)
    state, _ = _run(cfg, FRAMES)
    act = state.active.numpy()
    assert sorted(state.label.numpy()[act].tolist()) == [0, 1]
    # history of length 1: no velocity estimate
    np.testing.assert_allclose(state.velocity.numpy()[act], 0.0)


def test_stage6_velocity_and_coasting():
    """#6 periodic_corner_lost: velocity from history and prediction
    coasting."""
    cfg = TrackerConfig(max_tracks=16, history=6, frames_to_skip=3,
                        damping=0.0, smoothing=0.0, group_radius=0.0,
                        max_distance=30.0, max_frames=100)
    state, _ = _run(cfg, FRAMES)
    act = state.active.numpy()
    vel = state.velocity.numpy()[act]
    assert np.all(np.abs(vel[:, 0] - 5.0) < 1.5)   # ~5 px/frame in x
    # coast one empty frame: positions advance by about the velocity
    pos_before = state.pos.numpy()[act].copy()
    state2, _ = _run(cfg, [[]], state)
    pos_after = state2.pos.numpy()[state2.active.numpy()]
    assert np.all(pos_after[:, 0] > pos_before[:, 0] + 2.0)


def test_stage7_damping_smooths_direction():
    """#7 damping: the direction observer low-passes the step direction."""
    zigzag = [[(100 + 5 * k, 100 + (6 if k % 2 else -6))] for k in range(8)]
    cfg_damped = TrackerConfig(max_tracks=8, history=6, frames_to_skip=3,
                               damping=0.9, smoothing=0.5, group_radius=0.0)
    cfg_raw = TrackerConfig(max_tracks=8, history=6, frames_to_skip=3,
                            damping=0.0, smoothing=0.0, group_radius=0.0)
    sd, _ = _run(cfg_damped, zigzag)
    sr, _ = _run(cfg_raw, zigzag)
    vd = sd.velocity.numpy()[sd.active.numpy()][0]
    vr = sr.velocity.numpy()[sr.active.numpy()][0]
    assert abs(vd[1]) <= abs(vr[1]) + 1e-5


def test_stage8_groups_enabled_default():
    """#8 group_track: the built target, groups form with a real radius."""
    cfg = TrackerConfig(max_tracks=16, history=6, frames_to_skip=3, group_radius=60.0)
    state, groups = _run(cfg, FRAMES)
    gid = state.group_id.numpy()[state.active.numpy()]
    assert np.all(gid == gid[0]) and gid[0] >= 0   # one shared group
    assert int(groups.size[gid[0]]) == 2
