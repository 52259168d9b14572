"""End-to-end pipelines (counterpart of evflow_tpu/models/pipeline.py).

- cluster+flow (`cluster_flow_step`): hash dedup -> fast clustering ->
  centroid flow x extrapolation;
- corner+track (`corner_track_step`, q = 1): SAE scatter-max ->
  one representative candidate per touched pixel -> tile-predicated eFAST
  -> stream-order compaction -> NMS -> tracker;
- `full_scan`: both chains per slice over a slice sequence — the main path.

The JAX package's `lax.scan` over slices is an eager Python loop here.
Not ported yet (ROADMAP queue 1): exact mode and the q > 1 micro-slice
corner path.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from evflow_tpu.config import DEFAULT, EngineConfig
from evflow_tpu.io.events import EventStream
from evflow_tpu.io.slicing import slice_by_count, slice_by_time

from ..ops import efast, hash_dedup, nms as nms_ops, sae as sae_ops
from . import fastcluster, tracker as tracker_mod

_EXACT_TODO = ("mode='exact' is not ported yet (ROADMAP queue 1, still to "
               "port, item 3: exact mode with kernel update_slice_pallas)")
_MICRO_TODO = ("efast.micro_slices > 1 is not ported yet (ROADMAP queue 1, still "
               "to port, item 1: the q>1 serial micro-slice corner path)")


def _as_tensors(device, *arrays):
    return [torch.as_tensor(np.ascontiguousarray(a), device=device) for a in arrays]


def _stack(outs: Sequence[NamedTuple]):
    """Stack per-slice outputs along a new leading axis, as lax.scan does."""
    first = outs[0]
    if isinstance(first, tuple):
        return type(first)(*[_stack([o[i] for o in outs]) for i in range(len(first))])
    return torch.stack([torch.as_tensor(o) for o in outs])


def _to_cpu(out):
    if isinstance(out, tuple):
        return type(out)(*[_to_cpu(o) for o in out])
    return out.cpu()


# --------------------------------------------------------------------------
# cluster + flow
# --------------------------------------------------------------------------

class ClusterFlowOutput(NamedTuple):
    unique_count: torch.Tensor    # int32 ()
    repeated_count: torch.Tensor  # int32 ()
    reported: torch.Tensor        # bool (C,)
    cid: torch.Tensor             # int32 (C,)
    n: torch.Tensor               # int32 (C,)
    centroid: torch.Tensor        # float32 (C, 2)
    flow: torch.Tensor            # float32 (C, 2) extrapolated displacement


def cluster_flow_step(state: fastcluster.FastState, x: torch.Tensor,
                      y: torch.Tensor, valid: torch.Tensor,
                      cfg: EngineConfig = DEFAULT
                      ) -> Tuple[fastcluster.FastState, ClusterFlowOutput]:
    """One slice of the flagship pipeline (fast mode). The first-occupant
    mask is the clustering's validity, so labels index input events."""
    ded = hash_dedup.dedup_mask(x, y, valid, cfg.dedup, cfg.sensor)
    uvalid = ded.unique_mask
    if cfg.dedup.compat_stride2:
        # the reference consumes every 2nd unique coordinate
        upos = torch.cumsum(uvalid.to(torch.int32), 0, dtype=torch.int32) - 1
        uvalid = uvalid & (upos % 2 == 0)
    state, out = fastcluster.update_slice(state, x, y, uvalid, cfg.cluster,
                                          cfg.sensor)
    return state, ClusterFlowOutput(
        unique_count=ded.unique_count, repeated_count=ded.repeated_count,
        reported=out.reported, cid=out.cid, n=out.n, centroid=out.centroid,
        flow=out.flow * cfg.flow.extrapolation)


def cluster_flow_scan(state, xs, ys, valids, cfg: EngineConfig = DEFAULT):
    """All slices in order: (final state, stacked ClusterFlowOutput)."""
    outs = []
    for s in range(xs.shape[0]):
        state, out = cluster_flow_step(state, xs[s], ys[s], valids[s], cfg)
        outs.append(out)
    return state, _stack(outs)


@dataclasses.dataclass
class ClusterFlowPipeline:
    cfg: EngineConfig = DEFAULT
    mode: str = "fast"
    device: str = "cpu"

    def init_state(self) -> fastcluster.FastState:
        if self.mode != "fast":
            raise NotImplementedError(_EXACT_TODO)
        return fastcluster.init_state(self.cfg.cluster, device=self.device)

    def run(self, stream: EventStream, state=None) -> List[ClusterFlowOutput]:
        """Iterate recorded slices; per-slice outputs come back on the CPU.
        `self.final_state` afterwards is the state to resume from."""
        cfg = self.cfg
        if self.mode != "fast":
            raise NotImplementedError(_EXACT_TODO)
        if cfg.slicing.mode == "n_us":
            slices = slice_by_time(stream, cfg.slicing.n_us, cfg.slicing.n_events)
        else:
            slices = slice_by_count(stream, cfg.slicing.n_events)
        if state is None:
            state = self.init_state()
        xs, ys, vs = _as_tensors(self.device, slices.x, slices.y, slices.valid_mask())
        outs = []
        for s in range(slices.num_slices):
            state, out = cluster_flow_step(state, xs[s], ys[s], vs[s], cfg)
            outs.append(_to_cpu(out))
        self.final_state = state
        return outs


# --------------------------------------------------------------------------
# corner + track
# --------------------------------------------------------------------------

class CornerTrackState(NamedTuple):
    sae: torch.Tensor
    tracks: tracker_mod.TrackState
    slice_idx: torch.Tensor   # int32 () — detection starts after first slice


class CornerTrackOutput(NamedTuple):
    num_corners: torch.Tensor     # int32 () raw eFAST detections
    num_filtered: torch.Tensor    # int32 () after NMS
    track_active: torch.Tensor    # bool (T,)
    track_label: torch.Tensor     # int32 (T,)
    track_pos: torch.Tensor       # float32 (T, 2)
    track_vel: torch.Tensor       # float32 (T, 2)
    track_group: torch.Tensor     # int32 (T,)
    groups: tracker_mod.GroupView
    # touched pixels beyond cfg.efast.max_candidates, dropped in stream order
    num_dropped: torch.Tensor = np.int32(0)          # int32 ()
    # renderer fields (group_track.cpp:592,615-617)
    track_frames_since: torch.Tensor = np.int32(-1)  # int32 (T,)
    track_frame_count: torch.Tensor = np.int32(-1)   # int32 (T,)


def init_corner_state(cfg: EngineConfig = DEFAULT, device="cpu") -> CornerTrackState:
    return CornerTrackState(
        sae=sae_ops.init_sae(cfg.sensor, device=device),
        tracks=tracker_mod.init_state(cfg.tracker, device=device),
        slice_idx=torch.zeros((), dtype=torch.int32, device=device),
    )


def _corners_to_tracks(corner_mask, x, y, state: CornerTrackState, new_sae,
                       cfg: EngineConfig, n_dropped=None):
    """Compact the detected corners in stream order to the NMS capacity,
    suppress, and advance the tracker on the accepted candidate lanes."""
    n_corners = corner_mask.sum(dtype=torch.int32)
    cx, cy, cvalid = nms_ops.compact(corner_mask, cfg.nms.max_corners, x, y)
    accepted, n_filtered = nms_ops.accept_corners(cx, cy, cvalid, cfg.nms)
    tracks, groups = tracker_mod.update(
        state.tracks, cx.to(torch.float32), cy.to(torch.float32), accepted,
        cfg.tracker)
    if n_dropped is None:
        n_dropped = torch.zeros((), dtype=torch.int32, device=x.device)
    out = CornerTrackOutput(
        num_corners=n_corners, num_filtered=n_filtered,
        track_active=tracks.active, track_label=tracks.label,
        track_pos=tracks.pos, track_vel=tracks.velocity,
        track_group=tracks.group_id, groups=groups, num_dropped=n_dropped,
        track_frames_since=tracks.frames_since,
        track_frame_count=tracks.frame_count)
    return CornerTrackState(sae=new_sae, tracks=tracks,
                            slice_idx=state.slice_idx + 1), out


def _representative_candidates(x, y, valid, m, cfg: EngineConfig):
    """One representative lane per touched pixel — the pixel's LAST event in
    stream order, which carries its newest timestamp — compacted in stream
    order to m lanes. Returns (cx, cy, cvalid, n_dropped)."""
    n = x.shape[0]
    w1 = cfg.sensor.width + 1
    off = w1 * (cfg.sensor.height + 1)
    lane = torch.arange(n, dtype=torch.int64, device=x.device)
    pixkey = torch.where(valid, y * w1 + x, off).to(torch.int64)
    # (pixel, reversed lane) as one int64 key: each pixel's last lane first
    order = torch.sort(pixkey * n + (n - 1 - lane)).indices
    skey = pixkey[order]
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=x.device),
                       skey[1:] != skey[:-1]]) & (skey < off)
    n_rep = first.sum(dtype=torch.int32)
    keep = torch.zeros(n, dtype=torch.bool, device=x.device).scatter(0, order, first)
    cx, cy, cvalid = nms_ops.compact(keep, m, x, y)
    return cx, cy, cvalid, torch.clamp_min(n_rep - m, 0)


def corner_track_step(state: CornerTrackState, x: torch.Tensor, y: torch.Tensor,
                      t: torch.Tensor, valid: torch.Tensor,
                      cfg: EngineConfig = DEFAULT
                      ) -> Tuple[CornerTrackState, CornerTrackOutput]:
    """One slice of the corner pipeline, slice-synchronous (q = 1): the whole
    slice is scattered into the SAE first, then every touched pixel is
    tested once against it. Detection is skipped on the first slice."""
    if cfg.efast.micro_slices > 1:
        raise NotImplementedError(_MICRO_TODO)
    m = cfg.efast.max_candidates
    new_sae = sae_ops.update_sae(state.sae, x, y, t, valid)
    armed = state.slice_idx > 0
    if m and m < x.shape[0]:
        cx, cy, cvalid, n_dropped = _representative_candidates(x, y, valid, m, cfg)
        if cfg.efast.dense_detect:
            corner_mask = efast.detect_corners_dense(
                new_sae, ev_y=cy, ev_valid=cvalid, x=cx, y=cy, valid=cvalid,
                cfg=cfg.efast, sensor=cfg.sensor, ev_x=cx)
        else:
            corner_mask = efast.detect_corners(new_sae, cx, cy, cvalid,
                                               cfg.efast, cfg.sensor)
        return _corners_to_tracks(corner_mask & armed, cx, cy, state, new_sae,
                                  cfg, n_dropped)
    corner_mask = efast.detect_corners(new_sae, x, y, valid, cfg.efast, cfg.sensor)
    return _corners_to_tracks(corner_mask & armed, x, y, state, new_sae, cfg)


def corner_track_scan(state, xs, ys, ts, valids, cfg: EngineConfig = DEFAULT):
    """All slices in order: (final state, stacked CornerTrackOutput)."""
    outs = []
    for s in range(xs.shape[0]):
        state, out = corner_track_step(state, xs[s], ys[s], ts[s], valids[s], cfg)
        outs.append(out)
    return state, _stack(outs)


@dataclasses.dataclass
class CornerTrackPipeline:
    cfg: EngineConfig = DEFAULT
    device: str = "cpu"

    def run(self, stream: EventStream, state: Optional[CornerTrackState] = None,
            t0: Optional[int] = None) -> List[CornerTrackOutput]:
        """Iterate recorded slices; per-slice outputs come back on the CPU.
        Times are rebased by `t0` (the stream's first time by default) so the
        int32 SAE never wraps; `self.final_state` and `self.t0` are what a
        resume needs."""
        cfg = self.cfg
        slices = slice_by_count(stream, cfg.slicing.n_events)
        if t0 is None:
            t0 = int(stream.t[0]) if len(stream) else 0
        if state is None:
            state = init_corner_state(cfg, device=self.device)
        xs, ys, ts, vs = _as_tensors(self.device, slices.x, slices.y,
                                     (slices.t - t0).astype(np.int32),
                                     slices.valid_mask())
        outs = []
        for s in range(slices.num_slices):
            state, out = corner_track_step(state, xs[s], ys[s], ts[s], vs[s], cfg)
            outs.append(_to_cpu(out))
        self.final_state = state
        self.t0 = t0
        return outs


# --------------------------------------------------------------------------
# both chains
# --------------------------------------------------------------------------

def full_scan(cl_state, co_state, xs, ys, ts, valids, cfg: EngineConfig = DEFAULT):
    """Both pipelines per slice over (S, N) slices: returns
    ((cl_state, co_state), (stacked ClusterFlowOutput, stacked
    CornerTrackOutput)), the shape of the JAX package's full_scan."""
    cl_outs, co_outs = [], []
    for s in range(xs.shape[0]):
        cl_state, cl_out = cluster_flow_step(cl_state, xs[s], ys[s], valids[s], cfg)
        co_state, co_out = corner_track_step(co_state, xs[s], ys[s], ts[s],
                                             valids[s], cfg)
        cl_outs.append(cl_out)
        co_outs.append(co_out)
    return (cl_state, co_state), (_stack(cl_outs), _stack(co_outs))
