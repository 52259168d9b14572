"""Full-system trajectory parity through the port (the counterpart of
tests/test_ate.py): the port's corner pipeline step by step against the
JAX package's chained host oracles (sequential SAE -> eFAST scalar loops ->
NMS mask -> tracker transliteration), scored with the port's
utils.metrics. Same detections give identical trajectories: coverage 1 and
ATE below 1e-3 px.
"""

import numpy as np
import torch

from evflow_tpu.models.tracker_oracle import CornerTrackerOracle
from evflow_tpu.ops.efast import detect_corners_reference_numpy
from evflow_tpu.ops.nms import filter_corners_reference_numpy
from evflow_tpu_torch.config import (EngineConfig, NMSConfig, SensorConfig, SliceConfig,
                                     TrackerConfig)
from evflow_tpu_torch.models import pipeline
from evflow_tpu_torch.utils import metrics

W = H = 128
CFG = EngineConfig(
    sensor=SensorConfig(width=W, height=H),
    slicing=SliceConfig(n_events=1024),
    tracker=TrackerConfig(max_tracks=32, history=6, frames_to_skip=3,
                          max_frames=30, group_radius=60.0),
    nms=NMSConfig(max_corners=64),
)


def _wedge_slice(cx, cy, t0, n=1024, seed=0):
    """Events painting a fresh 90 degree wedge apexed at (cx, cy), a sure
    eFAST corner."""
    rng = np.random.default_rng(seed)
    x = rng.integers(max(0, cx - 40), cx + 1, n).astype(np.int32)
    y = rng.integers(max(0, cy - 40), cy + 1, n).astype(np.int32)
    t = (t0 + np.sort(rng.integers(0, 900, n))).astype(np.int32)
    return x, y, t


def test_corner_pipeline_trajectories_match_oracles():
    state = pipeline.init_corner_state(CFG, device="cpu")
    sae_ref = np.zeros((H, W), np.int64)
    oracle_tracker = CornerTrackerOracle(CFG.tracker)
    traj_engine, traj_oracle = {}, {}

    cx, cy = 50, 50
    for s in range(6):
        x, y, t = _wedge_slice(cx, cy, 1000 * (s + 1), seed=s)
        valid = np.ones(len(x), bool)
        state, out = pipeline.corner_track_step(
            state, torch.as_tensor(x), torch.as_tensor(y), torch.as_tensor(t),
            torch.as_tensor(valid), CFG)

        for xi, yi, ti in zip(x, y, t):
            sae_ref[yi, xi] = ti
        if s > 0:
            cmask = detect_corners_reference_numpy(sae_ref, x, y, CFG.efast, CFG.sensor)
            cand = [(int(a), int(b)) for a, b, m in zip(x, y, cmask) if m]
            filt = filter_corners_reference_numpy(
                [c[0] for c in cand], [c[1] for c in cand], W, H, CFG.nms)
        else:
            filt = []
        oracle_tracker.update([(float(a), float(b)) for a, b in filt])

        act = out.track_active.numpy()
        for slot in np.where(act)[0]:
            lab = int(out.track_label[slot])
            traj_engine.setdefault(lab, []).append(tuple(out.track_pos[slot].numpy()))
        for tr in oracle_tracker.tracks:
            traj_oracle.setdefault(tr.label, []).append((tr.x, tr.y))
        cx += 6  # the wedge's apex drifts right

    assert traj_oracle, "the oracle made no tracks: the scene is invalid"
    assert metrics.trajectory_coverage(traj_engine, traj_oracle) == 1.0, \
        (traj_engine.keys(), traj_oracle.keys())
    err = metrics.ate(traj_engine, traj_oracle)
    assert err < 1e-3, err
