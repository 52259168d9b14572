"""The fast clustering path's two kernels (counterpart of
evflow_tpu/ops/pallas_kernels.py), each beside its plain PyTorch version.

- `assign_manhattan` (csrc/assign_manhattan.cu): fastcluster step 1, the
  gated L1 assignment of events to cluster means.
- `cluster_stats` (csrc/cluster_stats.cu): fastcluster steps 3-4, member
  counts, stream-order ranks, EWMA weights and the (C, 5) aggregates; with
  `k_after`, the ranks of one tile of a tiled slice.

A wrapper launches its kernel for CUDA tensors and takes the plain version
for CPU tensors; the plain versions are what the CPU tests run and what the
card compares its kernels against.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .. import kernels

MAX_CLUSTERS = 4096   # both kernels keep per-cluster rows in shared memory


def log1m(alpha: float) -> float:
    """log(1 - alpha) as the f32 log1p gives it, computed on the host: a
    device tensor made from a Python scalar would cost a host-to-device
    copy and a sync per call."""
    return float(torch.log1p(torch.tensor(-alpha, dtype=torch.float32)))


def assign_manhattan_plain(x: torch.Tensor, y: torch.Tensor, mu: torch.Tensor,
                           alive: torch.Tensor, radius: float
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N,) int32 labels (-1 beyond the radius) and (N,) f32 distances:
    argmin over alive clusters of |x - mx| + |y - my|, first index on ties."""
    d = (x.to(torch.float32)[:, None] - mu[None, :, 0]).abs() \
        + (y.to(torch.float32)[:, None] - mu[None, :, 1]).abs()
    d = torch.where(alive[None, :], d, torch.inf)
    best = d.argmin(1).to(torch.int32)
    best_d = d.amin(1)
    return torch.where(best_d <= radius, best, -1), best_d


def assign_manhattan(x: torch.Tensor, y: torch.Tensor, mu: torch.Tensor,
                     alive: torch.Tensor, radius: float
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gated Manhattan assignment; x, y (N,) int32, mu (C, 2) f32, alive
    (C,) bool. See assign_manhattan_plain for the result."""
    n, c = x.shape[0], mu.shape[0]
    kernels.check(x, "x", torch.int32, (n,))
    kernels.check(y, "y", torch.int32, (n,))
    kernels.check(mu, "mu", torch.float32, (c, 2))
    kernels.check(alive, "alive", torch.bool, (c,))
    device = kernels.check_device(x, y, mu, alive)
    if device < 0:
        return assign_manhattan_plain(x, y, mu, alive, radius)
    if not 1 <= c <= MAX_CLUSTERS:
        raise ValueError(f"assign_manhattan: C={c} outside [1, {MAX_CLUSTERS}]")
    # two allocations: one buffer with labels and distances as views of it
    # measured more host time per call (PERF.md, section 6)
    labels = torch.empty(n, dtype=torch.int32, device=x.device)
    dist = torch.empty(n, dtype=torch.float32, device=x.device)
    if n:
        kernels.launch("assign_manhattan", device, x.data_ptr(), y.data_ptr(), n,
                       mu.data_ptr(), alive.data_ptr(), c, float(radius),
                       labels.data_ptr(), dist.data_ptr())
    return labels, dist


def cluster_stats_plain(labels: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                        alpha: float, c: int, k_after: torch.Tensor | None = None
                        ) -> torch.Tensor:
    """(C, 5) f32 [k, sum x, sum y, sum w x, sum w y] per cluster, with
    w = alpha (1-alpha)^clip(k-1-rank, 0, 80) and rank the member's
    stream-order position in its cluster; labels -1 belong to none. As the
    JAX oracle: an inclusive one-hot cumsum gives k - 1 - rank = k - P.
    With k_after ((C,) int32, the members of later tiles), the exponent is
    k + k_after - P: ranks count on into the tiles that follow."""
    n = labels.shape[0]
    iota = torch.arange(c, dtype=labels.dtype, device=labels.device)
    onehot = (labels[:, None] == iota[None, :]).to(torch.float32)   # (N, C)
    p = torch.cumsum(onehot, 0)
    k = p[-1] if n else torch.zeros(c, device=labels.device)
    la = log1m(alpha)
    if k_after is not None:
        k = k + k_after.to(torch.float32)
    expo = torch.clamp(k[None, :] - p, 0.0, 80.0)
    w = (onehot * (alpha * torch.exp(expo * la))).sum(1)
    member = (labels >= 0)[:, None]
    feats = torch.stack([torch.ones_like(x), x, y, w * x, w * y], 1)
    return onehot.T @ torch.where(member, feats, 0.0)


def cluster_stats(labels: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                  alpha: float, c: int, k_after: torch.Tensor | None = None
                  ) -> torch.Tensor:
    """Per-slice cluster statistics; labels (N,) int32, x, y (N,) f32,
    k_after (C,) int32 or None. Counts and ranks are exact; the weighted
    sums depend on f32 order. See cluster_stats_plain for the result."""
    n = labels.shape[0]
    kernels.check(labels, "labels", torch.int32, (n,))
    kernels.check(x, "x", torch.float32, (n,))
    kernels.check(y, "y", torch.float32, (n,))
    tensors = (labels, x, y)
    if k_after is not None:
        kernels.check(k_after, "k_after", torch.int32, (c,))
        tensors += (k_after,)
    device = kernels.check_device(*tensors)
    if device < 0:
        return cluster_stats_plain(labels, x, y, alpha, c, k_after)
    if not 0.0 < alpha < 1.0:
        raise ValueError(f"cluster_stats: alpha={alpha} outside (0, 1)")
    if c > MAX_CLUSTERS:
        raise ValueError(f"cluster_stats: C={c} above {MAX_CLUSTERS}")
    out = torch.empty((c, 5), dtype=torch.float32, device=labels.device)
    if c:
        kernels.launch("cluster_stats", device, labels.data_ptr(), x.data_ptr(),
                       y.data_ptr(), n, c, float(alpha),
                       None if k_after is None else k_after.data_ptr(), out.data_ptr())
    return out
