"""Point-cloud stages of app C (counterpart of
evflow_tpu/models/pointcloud.py): the reference's pcl_cluster.cpp chain of
a VoxelGrid downsample at leaf 0.01, a RANSAC plane fit (100 hypotheses,
threshold 0.02) and its removal, before DBSCAN (`models/dbscan.py`).

- `voxel_downsample`: the centroid of each occupied voxel, voxels hashed
  into num_buckets. The key is the JAX package's int32 arithmetic with
  wrap-around (its int64 is int32 with x64 off), so any bucket count
  gives JAX's buckets. Sums are `ops.segment`'s deterministic segmented
  sums: the same bits on two calls on the card.
- `ransac_plane`: all hypotheses scored at once. The (iters, 3) indices
  are JAX's own draw at the same seed, `jax.random.randint` on
  `PRNGKey(seed)`, reproduced in numpy on the host by `ops.jax_random`
  and moved to the points' device, so the card, the CPU and JAX score the
  same hypotheses. `_score_planes` scores given indices. Point-to-plane
  distances are explicit sums of 3 products, out of reach of any matmul
  precision setting (TF32 rounding is comparable to the 0.02 threshold).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import jax_random
from ..ops.segment import masked_segment_sum, segment_counts

_PRIMES = (73856093, 19349663, 83492791)


class VoxelResult(NamedTuple):
    points: torch.Tensor   # float32 (N, D) voxel centroids (compacted)
    count: torch.Tensor    # int32 () number of occupied voxels
    valid: torch.Tensor    # bool (N,)


def voxel_key(cell: torch.Tensor, num_buckets: int) -> torch.Tensor:
    """int64 (N,) bucket of (N, D) integer voxel coordinates: the sum of
    coordinate x prime taken with int32 wrap-around, then floor-mod
    num_buckets."""
    primes = torch.tensor(_PRIMES[:cell.shape[1]], dtype=torch.int64, device=cell.device)
    s = (cell.to(torch.int64) * primes).sum(1)
    s32 = torch.remainder(s + 2**31, 2**32) - 2**31
    return torch.remainder(s32, num_buckets)


def voxel_downsample(points: torch.Tensor, leaf: float,
                     valid: torch.Tensor | None = None,
                     num_buckets: int = 1 << 16) -> VoxelResult:
    """Centroid per voxel (PCL VoxelGrid), voxels hashed into num_buckets
    (a collision merges two voxels); the occupied buckets' centroids are
    compacted in bucket order into the first `count` of N rows."""
    n, d = points.shape
    dev = points.device
    pts = points.to(torch.float32)
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=dev)
    mins = torch.where(valid[:, None], pts, torch.inf).amin(0)
    cell = torch.floor((pts - mins[None, :]) / leaf)
    # an invalid lane's cell may be inf or nan: key it 0 before the cast,
    # it is parked in the overflow bucket below
    cell = torch.where(valid[:, None], cell, 0).to(torch.int64)
    key = torch.where(valid, voxel_key(cell, num_buckets), num_buckets)
    sums = masked_segment_sum(pts, key, num_buckets, valid)
    cnts = segment_counts(key, num_buckets, valid)
    occupied = cnts > 0
    centroids = sums / torch.clamp_min(cnts, 1)[:, None].to(torch.float32)
    pos = torch.cumsum(occupied.to(torch.int32), 0) - 1
    count = occupied.sum(dtype=torch.int32)
    spos = torch.where(occupied & (pos < n), pos, n).long()
    out = torch.zeros((n + 1, d), dtype=torch.float32, device=dev)
    out.index_put_((spos,), centroids)
    lane = torch.arange(n, device=dev)
    return VoxelResult(points=out[:n], count=torch.clamp_max(count, n), valid=lane < count)


class PlaneResult(NamedTuple):
    coeffs: torch.Tensor    # float32 (4,) plane ax+by+cz+d=0 (unit normal)
    inliers: torch.Tensor   # bool (N,)
    num_inliers: torch.Tensor


def ransac_plane(points: torch.Tensor, valid: torch.Tensor | None = None,
                 threshold: float = 0.02, iters: int = 100,
                 seed: int = 0) -> PlaneResult:
    """SACMODEL_PLANE RANSAC (pcl_cluster.cpp:66-77) on the points' device:
    `iters` 3-point hypotheses, drawn as JAX draws them at `seed` (threefry,
    on the host, then moved), scored at once; the most inliers win, the
    first such hypothesis on a tie."""
    n = points.shape[0]
    draw = jax_random.randint(jax_random.prng_key(seed), (iters, 3), 0, n)
    idx = torch.as_tensor(draw, device=points.device)
    return _score_planes(points, valid, idx, threshold)


def _score_planes(points: torch.Tensor, valid: torch.Tensor | None,
                  idx: torch.Tensor, threshold: float) -> PlaneResult:
    """Score the hypotheses through the (I, 3) point indices `idx`: a
    hypothesis counts if its normal is not degenerate and its three points
    are valid; its inliers are the valid points within threshold."""
    n = points.shape[0]
    pts = points.to(torch.float32)
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=pts.device)
    idx = idx.long()
    tri = pts[idx]                                   # (I, 3, D)
    v1 = tri[:, 1] - tri[:, 0]
    v2 = tri[:, 2] - tri[:, 0]
    normal = torch.linalg.cross(v1, v2, dim=1)       # (I, 3)
    norm = torch.sqrt((normal * normal).sum(1, keepdim=True))
    ok = (norm[:, 0] > 1e-12) & valid[idx].all(1)
    normal = normal / torch.clamp_min(norm, 1e-12)
    dcoef = -(normal * tri[:, 0]).sum(1)             # (I,)
    dot = normal[:, :1] * pts[:, 0][None, :]
    for k in range(1, pts.shape[1]):
        dot = dot + normal[:, k:k + 1] * pts[:, k][None, :]
    inl = ((dot + dcoef[:, None]).abs() <= threshold) & valid[None, :]
    counts = inl.sum(1, dtype=torch.int32) * ok
    best = torch.argmax(counts)
    return PlaneResult(coeffs=torch.cat([normal[best], dcoef[best][None]]),
                       inliers=inl[best], num_inliers=counts[best])


def remove_plane(points: torch.Tensor, valid: torch.Tensor,
                 plane: PlaneResult) -> torch.Tensor:
    """ExtractIndices with the negative filter (pcl_cluster.cpp:85-94): the
    validity mask with the plane's inliers removed."""
    return valid & ~plane.inliers
