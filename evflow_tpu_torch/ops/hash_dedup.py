"""Hash-grid event dedup (counterpart of evflow_tpu/ops/hash_dedup.py).

`(x*1619 + y*31) % 8192` buckets, first occupant in stream order wins, the
reference's inclusive `x <= width` / `y <= height` range check is kept, and
`repeated_count` counts buckets hit at least twice. First occupancy comes
from one sort of the packed key `key*n + lane`: run starts of the sorted
keys are each bucket's lowest lane. `dedup_batched` dedups (S, N) slices in
one sort; `dedup_sorted` is the JAX package's sort-based variant.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import DedupConfig, SensorConfig
from ..utils.profiling import spanned
from .segment import segment_counts


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


def _first_occupants(key: torch.Tensor, nkeys: int) -> DedupMask:
    """First-occupant mask and counts of (S, N) keys, invalid lanes parked
    at `nkeys`, for all S rows in one sort: row s's keys are offset by
    s * (nkeys + 1) and packed with the lane as `key * N + lane`, so each
    row's N entries sort into a run of their own and every packed key is
    unique. int32 where the packed keys fit, as in JAX."""
    s, n = key.shape
    span = nkeys + 1
    kdtype = torch.int32 if s * span * n <= 2**31 else torch.int64
    lane = torch.arange(n, dtype=kdtype, device=key.device)
    packed = key.to(kdtype) * n + lane
    if s > 1:   # one slice (the main path) needs no offset
        packed = packed + torch.arange(s, dtype=kdtype, device=key.device)[:, None] * (span * n)
    sp = torch.sort(packed.reshape(-1)).values.reshape(s, n)
    q = sp // n
    sk = q % span if s > 1 else q
    sl = sp - q * n
    true = torch.ones((s, 1), dtype=torch.bool, device=key.device)
    first = torch.cat([true, sk[:, 1:] != sk[:, :-1]], 1) & (sk < nkeys)
    unique_mask = torch.zeros((s, n), dtype=torch.bool, device=key.device).scatter(
        1, sl.long(), first)
    # buckets hit >= twice: a run start whose successor shares the key
    run2 = first & torch.cat([sk[:, 1:] == sk[:, :-1], ~true], 1)
    return DedupMask(unique_mask, first.sum(1, dtype=torch.int32),
                     run2.sum(1, dtype=torch.int32))


def _compact(x, y, unique_mask):
    """Stream-order compaction of the unique (x, y) along the last axis;
    lanes beyond the unique count are 0."""
    n = x.shape[-1]
    pos = torch.cumsum(unique_mask.to(torch.int32), -1, dtype=torch.int32) - 1
    # non-unique lanes write into a spare slot n, cut off below
    dst = torch.where(unique_mask, pos, n).long()
    zeros = torch.zeros(x.shape[:-1] + (n + 1,), dtype=torch.int32, device=x.device)
    ux = zeros.scatter(-1, dst, torch.where(unique_mask, x, 0).to(torch.int32))[..., :n]
    uy = zeros.scatter(-1, dst, torch.where(unique_mask, y, 0).to(torch.int32))[..., :n]
    return ux, uy


@spanned("dedup")
def dedup_mask(x: torch.Tensor, y: torch.Tensor, valid: torch.Tensor,
               cfg: DedupConfig = DedupConfig(),
               sensor: SensorConfig = SensorConfig()) -> DedupMask:
    """Per-event first-occupant mask plus unique and repeated counts."""
    key, nkeys, _ = _keys(x, y, valid, cfg, sensor)
    return DedupMask(*(a[0] for a in _first_occupants(key[None], nkeys)))


def dedup(x: torch.Tensor, y: torch.Tensor, valid: torch.Tensor,
          cfg: DedupConfig = DedupConfig(),
          sensor: SensorConfig = SensorConfig()) -> DedupResult:
    """dedup_mask plus the stream-order compaction of the unique (x, y);
    lanes beyond unique_count are 0."""
    unique_mask, unique_count, repeated_count = dedup_mask(x, y, valid, cfg, sensor)
    return DedupResult(*_compact(x, y, unique_mask), unique_mask, unique_count,
                       repeated_count)


def dedup_batched(x: torch.Tensor, y: torch.Tensor, valid: torch.Tensor,
                  cfg: DedupConfig = DedupConfig(),
                  sensor: SensorConfig = SensorConfig()) -> DedupResult:
    """`dedup` of each row of (S, N) inputs (JAX: its vmap), as one batched
    computation: one sort of all S rows' offset keys (`_first_occupants`)
    and one compaction. Every field gains the leading S axis."""
    key, nkeys, _ = _keys(x, y, valid, cfg, sensor)
    unique_mask, unique_count, repeated_count = _first_occupants(key, nkeys)
    return DedupResult(*_compact(x, y, unique_mask), unique_mask, unique_count,
                       repeated_count)


def dedup_sorted(x: torch.Tensor, y: torch.Tensor, valid: torch.Tensor,
                 cfg: DedupConfig = DedupConfig(),
                 sensor: SensorConfig = SensorConfig()) -> DedupResult:
    """Sort-based variant of `dedup` (same semantics, the JAX package's
    other cost profile): one stable sort of the composite int64 key
    `key * N + lane` (JAX sorts the pair (key, lane)); a lane is unique if
    it starts its key's run; `repeated_count` counts the keys whose run
    holds two lanes or more, from a segment count over the nkeys + 1 keys."""
    n = x.shape[0]
    key, nkeys, ok = _keys(x, y, valid, cfg, sensor)
    lane = torch.arange(n, dtype=torch.int64, device=x.device)
    sp = torch.sort(key.to(torch.int64) * n + lane, stable=True).values
    skey = sp // n
    sidx = sp - skey * n
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=x.device),
                       skey[1:] != skey[:-1]]) & (skey < nkeys)
    unique_mask = torch.zeros(n, dtype=torch.bool, device=x.device).scatter(
        0, sidx, first) & ok
    every = torch.ones(n, dtype=torch.bool, device=x.device)
    run_len = segment_counts(skey, nkeys + 1, every)
    repeated_count = (run_len[:nkeys] >= 2).sum(dtype=torch.int32)
    return DedupResult(*_compact(x, y, unique_mask), unique_mask,
                       unique_mask.sum(dtype=torch.int32), repeated_count)
