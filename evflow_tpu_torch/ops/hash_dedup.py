"""Hash-grid event dedup (counterpart of evflow_tpu/ops/hash_dedup.py).

`(x*1619 + y*31) % 8192` buckets, first occupant in stream order wins, the
reference's inclusive `x <= width` / `y <= height` range check is kept, and
`repeated_count` counts buckets hit at least twice. First occupancy comes
from one sort of the packed key `key*n + lane`: run starts of the sorted
keys are each bucket's lowest lane.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from evflow_tpu.config import DedupConfig, SensorConfig


class DedupResult(NamedTuple):
    unique_x: torch.Tensor       # int32 (N,) compacted unique xs (stream order)
    unique_y: torch.Tensor       # int32 (N,) compacted unique ys
    unique_mask: torch.Tensor    # bool  (N,) per-input-event first-occupant flag
    unique_count: torch.Tensor   # int32 ()   number of unique coordinates
    repeated_count: torch.Tensor # int32 ()   buckets with >=2 occupants


class DedupMask(NamedTuple):
    unique_mask: torch.Tensor    # bool  (N,)
    unique_count: torch.Tensor   # int32 ()
    repeated_count: torch.Tensor # int32 ()


def hash_coordinate(x: torch.Tensor, y: torch.Tensor,
                    cfg: DedupConfig) -> torch.Tensor:
    """(x*1619 + y*31) % 8192 — coordinate_processor.cl:12."""
    return (x * cfg.hash_mul_x + y * cfg.hash_mul_y) % cfg.num_buckets


def _keys(x, y, valid, cfg: DedupConfig, sensor: SensorConfig):
    if cfg.exact:
        # width+1 stride: the inclusive range check admits x == width, which
        # must not alias pixel (0, y+1)
        nkeys = (sensor.width + 1) * (sensor.height + 1)
        key = y * (sensor.width + 1) + x
    else:
        nkeys = cfg.num_buckets
        key = hash_coordinate(x, y, cfg)
    # inclusive bounds, as the reference's kernel checks them (cl:56)
    in_range = (x >= 0) & (x <= sensor.width) & (y >= 0) & (y <= sensor.height)
    ok = valid & in_range
    key = torch.where(ok, key, nkeys)   # park invalid lanes in an overflow key
    return key, nkeys, ok


def dedup_mask(x: torch.Tensor, y: torch.Tensor, valid: torch.Tensor,
               cfg: DedupConfig = DedupConfig(),
               sensor: SensorConfig = SensorConfig()) -> DedupMask:
    """Per-event first-occupant mask plus unique and repeated counts."""
    n = x.shape[0]
    key, nkeys, _ = _keys(x, y, valid, cfg, sensor)
    # one packed (key, lane) sort key; int32 where it fits, as in JAX
    kdtype = torch.int32 if (nkeys + 1) * n <= 2**31 else torch.int64
    idx = torch.arange(n, dtype=kdtype, device=x.device)
    sp = torch.sort(key.to(kdtype) * n + idx).values   # keys are unique
    sk = sp // n
    sl = sp - sk * n
    true = torch.ones(1, dtype=torch.bool, device=x.device)
    first = torch.cat([true, sk[1:] != sk[:-1]]) & (sk < nkeys)
    unique_mask = torch.zeros(n, dtype=torch.bool, device=x.device).scatter(
        0, sl.long(), first)
    unique_count = first.sum(dtype=torch.int32)
    # buckets hit >= twice: a run start whose successor shares the key
    run2 = first & torch.cat([sk[1:] == sk[:-1], ~true])
    repeated_count = run2.sum(dtype=torch.int32)
    return DedupMask(unique_mask, unique_count, repeated_count)


def dedup(x: torch.Tensor, y: torch.Tensor, valid: torch.Tensor,
          cfg: DedupConfig = DedupConfig(),
          sensor: SensorConfig = SensorConfig()) -> DedupResult:
    """dedup_mask plus the stream-order compaction of the unique (x, y);
    lanes beyond unique_count are 0."""
    n = x.shape[0]
    unique_mask, unique_count, repeated_count = dedup_mask(x, y, valid, cfg, sensor)
    pos = torch.cumsum(unique_mask.to(torch.int32), 0, dtype=torch.int32) - 1
    # non-unique lanes write into a spare slot n, cut off below
    dst = torch.where(unique_mask, pos, n).long()
    zeros = torch.zeros(n + 1, dtype=torch.int32, device=x.device)
    ux = zeros.scatter(0, dst, torch.where(unique_mask, x, 0))[:n]
    uy = zeros.scatter(0, dst, torch.where(unique_mask, y, 0))[:n]
    return DedupResult(ux, uy, unique_mask, unique_count, repeated_count)
