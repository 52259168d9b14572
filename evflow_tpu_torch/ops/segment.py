"""Segment reductions (counterpart of evflow_tpu/ops/segment.py).

Per-segment sums, counts, centroids and dense per-segment compaction, with
JAX's `mode="drop"` rule for ids outside [0, num_segments).

Float sums are deterministic on the card: the lanes are sorted by segment
id (stable, so each segment keeps stream order) and each run is summed by
`torch.segment_reduce`, which adds a run's values in order on a CPU tensor
(the order of the JAX package's scatter-add, so the same bits) and reduces
each run without atomics on a CUDA tensor, so two calls give the same bits
(`index_add_` on CUDA floats would not). Integer sums take `index_add_`,
exact in any order.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .sae import drop_index


def _segment_slot(segment_ids: torch.Tensor, num_segments: int,
                  valid: torch.Tensor | None = None) -> torch.Tensor:
    """int64 ids with dropped lanes sent to the overflow slot num_segments.
    Without `valid` (the scatters), a negative id wraps once, as `.at[]`
    does; with it (the sums), a negative id is dropped, as
    `jax.ops.segment_sum` does, and so is an invalid lane."""
    ids = segment_ids.long()
    if valid is None:
        ids, ok = drop_index(ids, num_segments)
    else:
        ok = valid & (ids >= 0) & (ids < num_segments)
    return torch.where(ok, ids, num_segments)


def scatter_min(values: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int, fill) -> torch.Tensor:
    """Per-segment min; segments with no lane hold `fill`."""
    init = torch.full((num_segments + 1,), fill, dtype=values.dtype, device=values.device)
    return init.scatter_reduce(0, _segment_slot(segment_ids, num_segments), values,
                               "amin")[:num_segments]


def scatter_max(values: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int, fill) -> torch.Tensor:
    """Per-segment max; segments with no lane hold `fill`."""
    init = torch.full((num_segments + 1,), fill, dtype=values.dtype, device=values.device)
    return init.scatter_reduce(0, _segment_slot(segment_ids, num_segments), values,
                               "amax")[:num_segments]


def masked_segment_sum(values: torch.Tensor, segment_ids: torch.Tensor,
                       num_segments: int, valid: torch.Tensor) -> torch.Tensor:
    """Per-segment sum of (N,) or (N, D) values over the valid lanes:
    (num_segments,) or (num_segments, D)."""
    ids = _segment_slot(segment_ids, num_segments, valid)
    if not values.is_floating_point():
        out = torch.zeros((num_segments + 1,) + values.shape[1:], dtype=values.dtype,
                          device=values.device)
        return out.index_add_(0, ids, values)[:num_segments]
    order = torch.sort(ids, stable=True).indices
    lengths = torch.bincount(ids, minlength=num_segments + 1)
    sums = torch.segment_reduce(values[order], "sum", lengths=lengths, axis=0,
                                unsafe=True)
    return sums[:num_segments]


def segment_counts(segment_ids: torch.Tensor, num_segments: int,
                   valid: torch.Tensor) -> torch.Tensor:
    """int32 (num_segments,) count of valid lanes per segment."""
    ones = torch.ones(segment_ids.shape, dtype=torch.int32, device=segment_ids.device)
    return masked_segment_sum(ones, segment_ids, num_segments, valid)


def segment_mean_points(points: torch.Tensor, segment_ids: torch.Tensor,
                        num_segments: int, valid: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-segment centroid of (N, D) points and the counts; an empty
    segment's centroid is 0."""
    sums = masked_segment_sum(points.to(torch.float32), segment_ids, num_segments, valid)
    counts = segment_counts(segment_ids, num_segments, valid)
    denom = torch.clamp_min(counts, 1).to(torch.float32)[:, None]
    return sums / denom, counts


def _place(points, ids, rank, keep, num_segments, capacity):
    """Rows of the (num_segments, capacity, D) table: each kept lane at
    (id, rank); the rest go to one pad row that is cut off."""
    d = points.shape[1]
    slots = num_segments * capacity
    flat, ok = drop_index(torch.where(keep, ids * capacity + rank, slots), slots + 1)
    out = torch.zeros((slots + 1, d), dtype=points.dtype, device=points.device)
    out.index_put_((torch.where(ok, flat, slots),), points)
    return out[:-1].reshape(num_segments, capacity, d)


def compact_by_segment(points: torch.Tensor, segment_ids: torch.Tensor,
                       num_segments: int, valid: torch.Tensor,
                       capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(num_segments, capacity, D) per-segment points in stream order and
    the counts, capped at capacity (members beyond it are dropped). Ranks
    from an O(N^2) comparison, as in JAX; `compact_by_segment_sorted` is
    the O(N log N) form."""
    n = points.shape[0]
    ids = torch.where(valid, segment_ids.long(), num_segments)
    lane = torch.arange(n, device=points.device)
    same = ids[:, None] == ids[None, :]
    rank = (same & (lane[:, None] > lane[None, :])).sum(1)
    keep = valid & (rank < capacity)
    out = _place(points, ids, rank, keep, num_segments, capacity)
    counts = segment_counts(segment_ids, num_segments, valid)
    return out, torch.clamp_max(counts, capacity)


def compact_by_segment_sorted(points: torch.Tensor, segment_ids: torch.Tensor,
                              num_segments: int, valid: torch.Tensor,
                              capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """compact_by_segment by one stable sort of the ids: a lane's rank is
    its distance from the start of its run."""
    n = points.shape[0]
    ids = torch.where(valid, segment_ids.long(), num_segments)
    sids, order = torch.sort(ids, stable=True)
    pos = torch.arange(n, device=points.device)
    first = torch.ones(n, dtype=torch.bool, device=points.device)
    first[1:] = sids[1:] != sids[:-1]
    run_start = torch.cummax(torch.where(first, pos, 0), 0).values
    rank = torch.empty(n, dtype=torch.int64, device=points.device).scatter_(
        0, order, pos - run_start)
    keep = valid & (rank < capacity)
    out = _place(points, ids, rank, keep, num_segments, capacity)
    counts = segment_counts(segment_ids, num_segments, valid)
    return out, torch.clamp_max(counts, capacity)
