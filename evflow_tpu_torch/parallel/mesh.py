"""Meshes of process-group ranks for the spatio-temporal layer (counterpart
of evflow_tpu/parallel/mesh.py).

JAX lays devices out on a named mesh and runs collectives along its axes
inside shard_map. Here every rank of a `torch.distributed` group is one
device of the mesh, and a mesh axis is an `Axis` record: the process group
of the ranks that share this rank's coordinates on the other axes, the
axis' size and this rank's index along it. Global rank = the row-major
index of the rank's coordinates, the last axis fastest: on a (data, tile)
grid, rank = data_index * n_tiles + tile_index, so each data-axis row is a
contiguous run of ranks in rank order (what parallel/temporal.py's window
loading relies on).

The collectives are one helper each:

  | JAX                      | here                                        |
  |--------------------------|---------------------------------------------|
  | lax.psum(x, ax)          | psum: all_reduce SUM in the axis group      |
  | lax.psum(1, ax)          | Axis.size                                   |
  | lax.all_gather(x, ax)    | all_gather: (size, ...) in axis-index order |
  | lax.axis_index(ax)       | Axis.index                                  |
  | lax.ppermute(x, ax, ...) | ppermute: all_gather, then the sender's row |

ppermute keeps JAX's wrap-around: with shift s, rank i receives from rank
(i - s) mod size, edge ranks included; the callers mask what the edges
receive. An all_gather and a pick is fine at the strip sizes it carries.

With no group initialized every axis has size 1 and no collective runs. In
a group, even a group of one rank, every collective runs (parallel/batch.py
follows the same rule). NCCL serves ranks that each hold their own card.
Gloo serves CPU tensors, and ranks that share one card: an axis whose group
is Gloo stages CUDA tensors through host memory (decided once, from the
group's backend, when the mesh is built).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..config import ParallelConfig


class Axis(NamedTuple):
    name: str
    size: int
    index: int            # this rank's index along the axis
    group: object         # its ProcessGroup; None outside a group (no collective)
    staged: bool          # Gloo: CUDA tensors go through host memory


class Mesh(NamedTuple):
    axes: Tuple[Axis, ...]

    def axis(self, name: str) -> Axis:
        for a in self.axes:
            if a.name == name:
                return a
        raise KeyError(f"mesh has no axis {name!r}: {[a.name for a in self.axes]}")


def grouped() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if grouped() else 1


def _build(names: Sequence[str], sizes: Sequence[int]) -> Mesh:
    total = int(np.prod(sizes))
    if not grouped():
        if total != 1:
            raise ValueError(f"a {dict(zip(names, sizes))} mesh needs {total} ranks; "
                             "torch.distributed is not initialized (one rank)")
        return Mesh(tuple(Axis(n, 1, 0, None, False) for n in names))
    rank = dist.get_rank()
    if dist.get_world_size() != total:
        raise ValueError(f"a {dict(zip(names, sizes))} mesh needs {total} ranks, "
                         f"the process group has {dist.get_world_size()}")
    grid = np.arange(total).reshape(sizes)
    coords = np.unravel_index(rank, sizes)
    axes = []
    for a, name in enumerate(names):
        # new_group is collective: every rank creates every line's group,
        # in the same order
        mine = None
        for line in np.moveaxis(grid, a, -1).reshape(-1, sizes[a]).tolist():
            g = dist.new_group(line)
            if rank in line:
                mine = g
        axes.append(Axis(name, int(sizes[a]), int(coords[a]), mine,
                         dist.get_backend(mine) == "gloo"))
    return Mesh(tuple(axes))


def make_tile_mesh(n_tiles: Optional[int] = None,
                   cfg: ParallelConfig = ParallelConfig()) -> Mesh:
    """1-D mesh over the tile axis: every rank of the group (n_tiles, by
    default the group's size, must equal it)."""
    return _build((cfg.tile_axis,), (n_tiles or world_size(),))


def make_grid_mesh(n_data: int, n_tiles: int,
                   cfg: ParallelConfig = ParallelConfig()) -> Mesh:
    """(data, tile) mesh: time windows over the data axis, tiles over the
    tile axis; rank = data_index * n_tiles + tile_index."""
    return _build((cfg.data_axis, cfg.tile_axis), (n_data, n_tiles))


def make_data_mesh(n_data: int, cfg: ParallelConfig = ParallelConfig()) -> Mesh:
    """1-D mesh over the data (time-window) axis, for the exact-engine
    temporal pipeline, which has no spatial tiling."""
    return _build((cfg.data_axis,), (n_data,))


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> None:
    """Multi-process bring-up: the default process group over
    `num_processes` ranks that meet at `coordinator` ("host:port"), NCCL
    where a card is present, else Gloo. A no-op for one process."""
    if num_processes is None or num_processes <= 1:
        return
    dist.init_process_group("nccl" if torch.cuda.is_available() else "gloo",
                            init_method=f"tcp://{coordinator}", world_size=num_processes,
                            rank=process_id)


# --------------------------------------------------------------------------
# collectives along one axis
# --------------------------------------------------------------------------

def _wire(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """x as the collective takes it: contiguous, bool as uint8, and in host
    memory where the axis stages CUDA tensors."""
    x = x.to(torch.uint8) if x.dtype == torch.bool else x
    if axis.staged and x.is_cuda:
        return x.cpu()
    return x.contiguous()


def _back(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return t.to(device=like.device, dtype=like.dtype)


def psum(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The sum of x over the axis' ranks, on every rank (a new tensor)."""
    if axis.group is None:
        return x
    buf = _wire(x, axis).clone()
    dist.all_reduce(buf, group=axis.group)
    return _back(buf, x)


def all_gather(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """(size, *x.shape): every rank's x, in axis-index order."""
    if axis.group is None:
        return x[None]
    src = _wire(x, axis)
    parts = [torch.empty_like(src) for _ in range(axis.size)]
    dist.all_gather(parts, src, group=axis.group)
    return _back(torch.stack(parts), x)


def ppermute(x: torch.Tensor, axis: Axis, shift: int) -> torch.Tensor:
    """lax.ppermute with perm [(i, (i + shift) % size)]: the x of the rank
    `shift` places before this one, wrapping around."""
    return all_gather(x, axis)[(axis.index - shift) % axis.size]
