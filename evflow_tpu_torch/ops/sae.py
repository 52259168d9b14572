"""SAE time surface (counterpart of evflow_tpu/ops/sae.py).

Per-pixel last-event timestamp plane. Timestamps are nondecreasing in stream
order, so the reference's sequential `at(y, x) = t` is a scatter-max; here
`scatter_reduce(amax)` on flat indices. Not a Pallas kernel in JAX either
(ops/pallas_kernels.py explains why), so no hand kernel stands behind it.
"""

from __future__ import annotations

from typing import Tuple

import torch

from evflow_tpu.config import SensorConfig


def init_sae(sensor: SensorConfig = SensorConfig(), device="cpu",
             dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """(H, W) zero surface — time_surface.set_to(0) (group_track.cpp:787)."""
    return torch.zeros((sensor.height, sensor.width), dtype=dtype, device=device)


def drop_index(i: torch.Tensor, dim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """JAX's mode="drop" index rule: a negative index wraps once, NumPy
    style, and what is then still outside [0, dim) is dropped. Returns the
    wrapped index and its keep mask."""
    i = torch.where(i < 0, i + dim, i)
    return i, (i >= 0) & (i < dim)


def _lowest(dtype: torch.dtype):
    if dtype.is_floating_point:
        return -torch.inf
    return torch.iinfo(dtype).min


def update_sae(sae: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
               t: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Scatter-max one slice of events into the surface (a new tensor).
    Invalid lanes carry the lowest value, and out-of-range lanes are
    dropped, so neither changes any pixel."""
    h, w = sae.shape
    yi, oky = drop_index(y, h)
    xi, okx = drop_index(x, w)
    keep = oky & okx
    tval = torch.where(valid & keep, t.to(sae.dtype), _lowest(sae.dtype))
    flat = torch.where(keep, yi * w + xi, 0).long()
    return sae.reshape(-1).scatter_reduce(0, flat, tval, "amax").reshape(h, w)


def last_time(t: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Latest valid timestamp of the slice."""
    return torch.where(valid, t, _lowest(t.dtype)).amax()
