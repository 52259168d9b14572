"""Pairwise distances and nearest-center assignment (counterpart of
evflow_tpu/ops/distance.py).

No matmul: the cross term of |a|^2 + |b|^2 - 2 a.b is an explicit sum of
D elementwise products, so no float32 matmul precision setting (TF32 under
`torch.set_float32_matmul_precision("high")`) can reach it. On TPU the same
class of fault, a low-precision 2ab term, inflated neighbor counts 80x
(the JAX module's `pairwise_sqdist` note). With integer coordinates below
2^11 every term is exact in fp32, so neighbor tests on event pixels give
the same bits on the card, on the CPU and in JAX.

The squared norms are summed term by term from the first coordinate, as
the cross term is, so every rounding of `pairwise_sqdist` has a fixed
order that a kernel can repeat.

The eps tests of DBSCAN (`eps_counts`, `eps_min_label`, and
`radius_neighbor_counts` over them) reduce each row's tests to one int32.
CUDA tensors launch the hand-written kernel csrc/dbscan_eps.cu (D = 2,
event pixels, or D = 3, point clouds; another D raises on the card): one
launch over all rows, no sync, no distance written, and the same bits as
the panels on any float32 input (it spells out `pairwise_sqdist`'s
roundings, with no FMA). CPU tensors take the plain versions, (block, N)
panels of `pairwise_sqdist`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import kernels

NO_LABEL = 2**31 - 1   # eps_min_label's answer for a row with no core point within eps


def _sq_norm(a: torch.Tensor) -> torch.Tensor:
    """(M, D) -> (M,) squared norms, summed term by term from the first
    coordinate (a fixed order, unlike a reduction's)."""
    s = a[:, 0] * a[:, 0]
    for k in range(1, a.shape[1]):
        s = s + a[:, k] * a[:, k]
    return s


def pairwise_sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, D), (K, D) -> (M, K) squared Euclidean distances, clamped at 0
    (a NaN stays NaN)."""
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    a2 = _sq_norm(a)[:, None]                               # (M, 1)
    b2 = _sq_norm(b)[None, :]                               # (1, K)
    cross = a[:, :1] * b[:, 0][None, :]
    for k in range(1, a.shape[1]):
        cross = cross + a[:, k:k + 1] * b[:, k][None, :]
    return torch.maximum(a2 + b2 - 2.0 * cross, torch.zeros((), device=a.device))


def pairwise_manhattan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, D), (K, D) -> (M, K) L1 distances."""
    return (a[:, None, :].to(torch.float32) - b[None, :, :].to(torch.float32)).abs().sum(-1)


class AssignResult(NamedTuple):
    labels: torch.Tensor   # int32 (M,) nearest center in 0..K-1, or -1 if gated
    dists: torch.Tensor    # float32 (M,) distance to the assigned center (inf if gated)


def assign_to_centers(points: torch.Tensor, centers: torch.Tensor,
                      threshold: float = 50.0) -> AssignResult:
    """Nearest center under a distance gate: the first of equally near
    centers wins (argmin's first index); a point with no center nearer
    than `threshold` gets -1. The exact (M, K, D) difference form, as in
    JAX: K is small, and the matmul form's cancellation could flip labels
    near Voronoi edges."""
    diff = points[:, None, :].to(torch.float32) - centers[None, :, :].to(torch.float32)
    d = torch.sqrt((diff * diff).sum(-1))
    labels = torch.argmin(d, 1).to(torch.int32)
    best = d.amin(1)
    gated = best < threshold
    return AssignResult(torch.where(gated, labels, -1),
                        torch.where(gated, best, torch.inf))


def _eps2(eps: float, device) -> torch.Tensor:
    return torch.full((), eps * eps, dtype=torch.float32, device=device)


def _by_blocks(rows: torch.Tensor, block: int, fn, empty: torch.Tensor) -> torch.Tensor:
    """fn of each (block, D) row block, concatenated."""
    out = [fn(rows[i:i + block]) for i in range(0, rows.shape[0], block)]
    return torch.cat(out) if out else empty


def eps_counts_plain(rows: torch.Tensor, points: torch.Tensor, eps: float,
                     valid: torch.Tensor, row_valid: torch.Tensor,
                     block: int = 2048) -> torch.Tensor:
    """`eps_counts` by (block, N) panels."""
    eps2 = _eps2(eps, points.device)
    pts = points.to(torch.float32)

    def counts(a):
        return ((pairwise_sqdist(a, pts) <= eps2) & valid[None, :]).sum(1, dtype=torch.int32)

    out = _by_blocks(rows.to(torch.float32), block, counts,
                     torch.zeros(0, dtype=torch.int32, device=points.device))
    return torch.where(row_valid, out, 0)


def eps_min_label_plain(rows: torch.Tensor, points: torch.Tensor, eps: float,
                        labels: torch.Tensor, core: torch.Tensor,
                        row_labels: torch.Tensor | None = None,
                        row_core: torch.Tensor | None = None,
                        block: int = 2048) -> torch.Tensor:
    """`eps_min_label` by (block, N) panels."""
    eps2 = _eps2(eps, points.device)
    pts = points.to(torch.float32)
    src = torch.where(core, labels, NO_LABEL)[None, :]

    def nmin(a):
        return torch.where(pairwise_sqdist(a, pts) <= eps2, src, NO_LABEL).amin(1)

    out = _by_blocks(rows.to(torch.float32), block, nmin,
                     torch.full((0,), NO_LABEL, dtype=labels.dtype, device=labels.device))
    if row_labels is None:
        return out
    return torch.where(row_core, torch.minimum(row_labels, out), row_labels)


def _kernel_device(rows: torch.Tensor, points: torch.Tensor, *others) -> int:
    """The CUDA device index of the tensors (the kernel), or -1 for the CPU
    (the plain version). The kernel takes D = 2 or 3: another D raises on
    the card."""
    device = kernels.check_device(rows, points, *(t for t in others if t is not None))
    if device >= 0 and not (rows.shape[1] == points.shape[1] and rows.shape[1] in (2, 3)):
        raise ValueError(f"dbscan_eps takes 2-D or 3-D rows and points, got "
                         f"{tuple(rows.shape)} and {tuple(points.shape)}")
    return device


def _launch_eps(device: int, rows, points, eps: float, pflag, plabel=None, rflag=None,
                rlabel=None) -> torch.Tensor:
    m, n = rows.shape[0], points.shape[0]
    rows = rows.to(torch.float32).contiguous()
    points = points.to(torch.float32).contiguous()
    kernels.check(pflag, "point flags", torch.bool, (n,))
    for t, name, dtype, size in ((plabel, "labels", torch.int32, n),
                                 (rflag, "row flags", torch.bool, m),
                                 (rlabel, "row labels", torch.int32, m)):
        if t is not None:
            kernels.check(t, name, dtype, (size,))
    out = torch.empty(m, dtype=torch.int32, device=rows.device)
    if m == 0:
        return out

    def ptr(t):
        return None if t is None else t.data_ptr()

    kernels.launch("dbscan_eps", device, rows.data_ptr(), m, points.data_ptr(), n,
                   rows.shape[1], eps * eps,
                   pflag.data_ptr(), ptr(plabel), ptr(rflag), ptr(rlabel), out.data_ptr())
    return out


def eps_counts(rows: torch.Tensor, points: torch.Tensor, eps: float, valid: torch.Tensor,
               row_valid: torch.Tensor, block: int = 2048) -> torch.Tensor:
    """int32 (M,) count of the valid points within eps of each row of
    (M, D) `rows`, among (N, D) `points` (bool (N,) `valid`), 0 for a row
    that is not valid (bool (M,) `row_valid`). CUDA tensors launch
    csrc/dbscan_eps.cu (count mode), CPU tensors take the panels."""
    device = _kernel_device(rows, points, valid, row_valid)
    if device < 0:
        return eps_counts_plain(rows, points, eps, valid, row_valid, block)
    return _launch_eps(device, rows, points, eps, valid, rflag=row_valid)


def eps_min_label(rows: torch.Tensor, points: torch.Tensor, eps: float,
                  labels: torch.Tensor, core: torch.Tensor,
                  row_labels: torch.Tensor | None = None,
                  row_core: torch.Tensor | None = None,
                  block: int = 2048) -> torch.Tensor:
    """int32 (M,) lowest `labels[j]` over the core points j (bool (N,)
    `core`) within eps of each row, or NO_LABEL where there is none. Each
    row's answer depends on that row alone (parallel/batch.py takes row
    blocks). With `row_labels` and `row_core`, a propagation round:
    row_core ? min(row_labels, that) : row_labels. CUDA tensors launch
    csrc/dbscan_eps.cu (min-label mode), CPU tensors take the panels."""
    device = _kernel_device(rows, points, labels, core, row_labels, row_core)
    if device < 0:
        return eps_min_label_plain(rows, points, eps, labels, core, row_labels, row_core,
                                   block)
    return _launch_eps(device, rows, points, eps, core, labels, row_core, row_labels)


def radius_neighbor_counts(points: torch.Tensor, eps: float,
                           valid: torch.Tensor | None = None,
                           block: int = 2048) -> torch.Tensor:
    """int32 (N,) count of valid points within eps of each point, itself
    included (0 for an invalid point): `eps_counts` of the points against
    themselves."""
    if valid is None:
        valid = torch.ones(points.shape[0], dtype=torch.bool, device=points.device)
    return eps_counts(points, points, eps, valid, valid, block)


def kth_neighbor_dist(points: torch.Tensor, k: int, eps: float | None = None,
                      block: int = 2048) -> torch.Tensor:
    """(N,) distance to the k-th nearest point, the point itself counted
    (OPTICS' core distance at k = min_pts). With eps, distances beyond it
    are inf, so a point with fewer than k within eps gets inf."""
    n = points.shape[0]
    pts = points.to(torch.float32)
    out = []
    for i in range(0, n, block):
        d = torch.sqrt(pairwise_sqdist(pts[i:i + block], pts))
        if eps is not None:
            d = torch.where(d <= torch.tensor(eps, dtype=torch.float32, device=d.device),
                            d, torch.inf)
        out.append(torch.topk(d, k, 1, largest=False).values[:, k - 1])
    return torch.cat(out) if out else torch.zeros(0, dtype=torch.float32, device=pts.device)
