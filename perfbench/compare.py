"""The numbers that decide `correct`: the system's outputs against the
reference's on the same slices, each held to its limit in
`limits/<configuration>.json`. A path module picks its numbers
(`numbers(prog, ref)`) from these:

- `discrete_mismatches`: elements of discrete outputs (counts, masks, ids)
  that differ, over every compared slice.
- `float_gap_px`: the widest gap of a float output (coordinates, flows,
  velocities, radii: pixels or pixels per slice) over every element. A NaN
  on one side only is an infinite gap.
- `unmatched_clusters`: per slice, the reported clusters of each side as a
  multiset of (members, centroid, flow), centroid and flow to 1e-3 px; the
  clusters of either side that the other lacks, summed over the slices.
  Slot and id do not enter: one event that f32 summation order moves across
  the radius gate renumbers every later cluster, but changes the multiset
  only where members change.
"""

from __future__ import annotations

from collections import Counter

import numpy as np


def discrete_mismatches(prog: dict, ref: dict, fields: tuple) -> int:
    mism = 0
    for f in fields:
        a, b = np.asarray(prog[f]), np.asarray(ref[f])
        mism += max(a.size, b.size) if a.shape != b.shape else int(np.count_nonzero(a != b))
    return mism


def float_gap_px(prog: dict, ref: dict, fields: tuple) -> float:
    gap = 0.0
    for f in fields:
        a = np.asarray(prog[f], np.float64)
        b = np.asarray(ref[f], np.float64)
        if a.shape != b.shape or np.any(np.isnan(a) != np.isnan(b)):
            return float("inf")
        d = np.abs(np.where(np.isnan(a), 0.0, a - b))
        if d.size:
            gap = max(gap, float(d.max()))
    return gap


def _clusters(out: dict, s: int) -> Counter:
    rep = np.asarray(out["reported"][s], bool)
    rows = np.concatenate([np.asarray(out["n"][s])[rep, None].astype(np.float64),
                           np.asarray(out["centroid"][s], np.float64)[rep],
                           np.asarray(out["flow"][s], np.float64)[rep]], 1)
    return Counter(map(tuple, np.round(rows, 3).tolist()))


def unmatched_clusters(prog: dict, ref: dict) -> int:
    total = 0
    for s in range(len(prog["reported"])):
        p, r = _clusters(prog, s), _clusters(ref, s)
        total += sum((p - r).values()) + sum((r - p).values())
    return total


def stack(outs: list) -> dict:
    """Per-slice dicts -> field -> (S, ...) arrays."""
    return {f: np.stack([np.asarray(o[f]) for o in outs]) for f in outs[0]}
