"""The exact AEClustering engine as one CUDA kernel per slice (counterpart
of evflow_tpu/models/aeclustering_pallas.py:update_slice_pallas).

`update_slice_kernel` is a drop-in for `aeclustering.update_slice`: the
shared slice prep (`_slice_prep`: relative times, per-lane tMin, push
buffer), one launch of csrc/aeclustering_exact.cu for the whole per-event
state machine, then the shared `_finalize`. The kernel keeps the member ring
in shared memory and forgets by chasing the expired ring prefix with per-
cluster live counts (expiry is a prefix because times and tMin are monotone),
so it needs the ring's live window as a tail pointer and the live count of
each cluster at the slice start; both are computed here. It reads the valid
lanes only, compacted here into 16-byte rows (x, y, t, tMin), and keeps of
each member its time, slot and source lane: the members' x, y and p are
gathered here from the source lanes after the launch.

The event count stays a device tensor that the kernel reads: nothing is
read back to the host. CPU tensors take the plain version. On a CUDA tensor
the wrapper launches the kernel or raises: kappa must be 0 (the deployed
default; the sampling branch has no kernel, as in JAX), and C and M must
fit the kernel's lanes and shared memory.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import ClusterConfig

from .. import kernels
from .aeclustering import AEState, _finalize, _slice_prep, update_slice

_I32 = torch.int32
MAX_CLUSTERS = 256    # 32 threads x 8 cluster lanes each, in registers
MAX_MEMBERS = 8192    # ring of 3 int32 rows in shared memory: 96 KB


def update_slice_kernel(state: AEState, x, y, t, p, valid,
                        cfg: ClusterConfig = ClusterConfig()) -> AEState:
    """One slice of the exact engine; bit-equal to `update_slice` on every
    AEState field (integer and bool fields always; mu up to the order of
    the merge sum over three or more clusters, see the kernel source)."""
    m, c, n = cfg.max_members, cfg.max_clusters, x.shape[0]
    device = kernels.check_device(x, y, t, p, valid, state.mu)
    if device < 0:
        return update_slice(state, x, y, t, p, valid, cfg)
    if cfg.kappa != 0:
        raise ValueError("update_slice_kernel: kappa != 0 has no kernel; "
                         "use aeclustering.update_slice")
    if not 1 <= c <= MAX_CLUSTERS:
        raise ValueError(f"update_slice_kernel: C={c} outside [1, {MAX_CLUSTERS}]")
    if not 1 <= m <= MAX_MEMBERS:
        raise ValueError(f"update_slice_kernel: M={m} outside [1, {MAX_MEMBERS}]")
    kernels.check(valid, "valid", torch.bool, (n,))

    x, y, tr, p, t0, has_any, tmin, tbuf, thead = _slice_prep(
        state, x, y, t, p, valid, cfg)
    dev = x.device
    # the valid lanes, compacted in order (invalid lanes are no-ops), as
    # (N, 4) rows [x, y, t, tmin]; rows past the valid count are never read
    pos = torch.cumsum(valid.to(_I32), 0, dtype=_I32) - 1
    lane_of = torch.zeros(n + 1, dtype=torch.int64, device=dev).scatter_(
        0, torch.where(valid, pos, n).long(), torch.arange(n, device=dev))[:n]
    ev = torch.stack([x, y, tr, tmin], 1)[lane_of].contiguous()

    # the live members are the ring's newest n_live rows
    member = state.mcid >= 0
    n_live = member.sum(dtype=_I32)
    nc0 = torch.zeros(c + 1, dtype=_I32, device=dev).scatter_add(
        0, torch.where(member, state.mcid, c).long(), member.to(_I32))[:c]
    ring = torch.stack([state.mt, state.mcid])
    ivec = torch.stack([state.alive.to(_I32), state.corder, state.cid, nc0])
    scal = torch.stack([state.event_id - n_live, state.event_id, state.next_order,
                        state.next_cid, state.last_updated, state.overflow,
                        valid.sum(dtype=_I32), torch.zeros((), dtype=_I32, device=dev)])
    mu = state.mu.contiguous()

    ring_o = torch.empty((3, m), dtype=_I32, device=dev)
    ivec_o = torch.empty_like(ivec)
    mu_o = torch.empty_like(mu)
    scal_o = torch.empty_like(scal)
    # both EWMA constants as the plain version rounds them: (1 - alpha) in
    # double, then to f32 (not f32(1) - f32(alpha))
    kernels.launch("aeclustering_exact", device, scal.data_ptr(), ev.data_ptr(),
                   ring.data_ptr(), ivec.data_ptr(), mu.data_ptr(), m, c,
                   float(np.float32(cfg.radius)), float(np.float32(cfg.alpha)),
                   float(np.float32(1.0 - cfg.alpha)), ring_o.data_ptr(),
                   ivec_o.data_ptr(), mu_o.data_ptr(), scal_o.data_ptr())
    # x, y, p of the members appended in this slice, from their source lanes
    mt, mcid, src = ring_o.unbind(0)
    older = src < 0
    lane = lane_of[src.clamp_min(0).long()]
    ring5 = torch.stack([torch.where(older, state.mx, x[lane]),
                         torch.where(older, state.my, y[lane]), mt,
                         torch.where(older, state.mp, p[lane]), mcid])
    carry = (ivec_o[0] > 0, ivec_o[1], ivec_o[2], mu_o, ring5,
             scal_o[2], scal_o[3], scal_o[1], scal_o[4], scal_o[5])
    return _finalize(state, carry, t0, has_any, tmin, tbuf, thead, valid, cfg)
