"""Corner non-maximum suppression (counterpart of evflow_tpu/ops/nms.py).

Greedy first-come box suppression (CornerFilter, group_track.cpp:81-152):
accept a corner iff no earlier accepted corner's box intersects its box,
i.e. |dx| <= 2*half and |dy| <= 2*half. The greedy result is the unique
fixpoint of
    accepted[i] = NOT any(j < i, accepted[j], overlap(i, j))
reached by iterating from the valid set. Each round is one (C, C) masked
reduction, and the loop checks convergence on the host: one device-to-host
sync per round, rounds = suppression-chain depth + 1.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from evflow_tpu.config import NMSConfig


class NMSResult(NamedTuple):
    x: torch.Tensor        # int32 (C,) accepted corners, compacted in order
    y: torch.Tensor        # int32 (C,)
    label: torch.Tensor    # int32 (C,) acceptance order (= position)
    count: torch.Tensor    # int32 ()
    accepted: torch.Tensor # bool (C,) per-candidate accept flag (input order)


def accept_corners(x: torch.Tensor, y: torch.Tensor, valid: torch.Tensor,
                   cfg: NMSConfig = NMSConfig()) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy accept mask over candidates in input order: (accepted bool
    (C,), count int32 ())."""
    c = x.shape[0]
    reach = 2 * (cfg.box_size // 2)
    xf = x.to(torch.int32)
    yf = y.to(torch.int32)
    overlap = ((xf[:, None] - xf[None, :]).abs() <= reach) \
        & ((yf[:, None] - yf[None, :]).abs() <= reach)
    lane = torch.arange(c, device=x.device)
    earlier = lane[:, None] > lane[None, :]              # j < i
    sup = overlap & earlier & valid[:, None] & valid[None, :]

    acc = valid
    while True:
        new = valid & ~(sup & acc[None, :]).any(1)
        if torch.equal(new, acc):
            break
        acc = new
    return acc, acc.sum(dtype=torch.int32)


def compact(keep: torch.Tensor, cap: int, *cols: torch.Tensor):
    """The lanes where `keep` holds, in lane (stream) order, in `cap` slots:
    a stable sort on lane keys, zero past the count. Returns the compacted
    columns and their (cap,) validity."""
    n = keep.shape[0]
    lane = torch.arange(n, dtype=torch.int32, device=keep.device)
    order = torch.sort(torch.where(keep, lane, n), stable=True).indices
    valid = torch.arange(cap, device=keep.device) \
        < torch.clamp_max(keep.sum(dtype=torch.int32), cap)
    out = []
    for col in cols:
        col = col[order]
        if cap > n:
            col = torch.nn.functional.pad(col, (0, cap - n))
        out.append(torch.where(valid, col[:cap], 0))
    return (*out, valid)


def filter_corners(x: torch.Tensor, y: torch.Tensor, valid: torch.Tensor,
                   cfg: NMSConfig = NMSConfig()) -> NMSResult:
    """`accept_corners` followed by the stream-order compaction of the
    accepted corners."""
    c = x.shape[0]
    acc, count = accept_corners(x, y, valid, cfg)
    ox, oy, live = compact(acc, c, x.to(torch.int32), y.to(torch.int32))
    lane = torch.arange(c, dtype=torch.int32, device=x.device)
    return NMSResult(ox, oy, torch.where(live, lane, -1), count, acc)
