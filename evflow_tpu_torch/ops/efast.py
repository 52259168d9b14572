"""eFAST corner detection on the SAE (counterpart of evflow_tpu/ops/efast.py).

Two Bresenham circles — radius 3 (16 px) and radius 4 (20 px) — and a
streak test: a pixel is a corner if some contiguous arc of 3..6 pixels on
circle3 has all timestamps strictly newer than every off-arc pixel (with the
two boundary monotonicity checks), and likewise an arc of 4..8 on circle4.

- `detect_corners`: per-candidate test with a direct 36-point gather (the
  JAX package's 8x8-block gather layout works around the TPU gather unit
  and is not carried over); `detect_corners_stacked`, the same over a
  stack of surface snapshots at once. Both are one launch of the CUDA
  kernel csrc/efast_ring.cu on the card (`_ring_test`); CPU tensors take
  its plain version, `_ring_test_plain`.
- `corner_mask_stencil`: the dense mask over (band x 128-px) tiles, computed
  by the CUDA kernel csrc/efast_stencil.cu on the card, where inactive tiles
  are skipped and come back False. On CPU tensors it takes its plain
  version, `corner_mask_stencil_plain`.
- `corner_mask_dense` / `corner_mask_dense_banded`: the whole-surface plain
  stencil, as planes of static shifts of the zero-padded SAE.
- `streak_any_scan`: the stencil kernel's per-ring arithmetic (early reject,
  length-limited scan) on the CPU, which the tests hold to `_streak_any`.
- `detect_corners_dense`: the slice's main-path detector — activity map,
  dense mask, candidate look-up.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import EFastConfig, SensorConfig

from .. import kernels
from ..utils.profiling import spanned

# (dy, dx) in group_track order: time_surface.at(y + c[i][0], x + c[i][1]).
CIRCLE3 = np.array(
    [[0, 3], [1, 3], [2, 2], [3, 1], [3, 0], [3, -1], [2, -2], [1, -3],
     [0, -3], [-1, -3], [-2, -2], [-3, -1], [-3, 0], [-3, 1], [-2, 2], [-1, 3]],
    dtype=np.int32,
)
CIRCLE4 = np.array(
    [[0, 4], [1, 4], [2, 3], [3, 2], [4, 1], [4, 0], [4, -1], [3, -2], [2, -3],
     [1, -4], [0, -4], [-1, -4], [-2, -3], [-3, -2], [-4, -1], [-4, 0], [-4, 1],
     [-3, 2], [-2, 3], [-1, 4]],
    dtype=np.int32,
)
WTILE = 128   # column tile of the dense stencil


def _ring_offsets(cfg: EFastConfig):
    """(dy, dx) lists for circle3 then circle4 in the configured axis order
    (fast_corner.cpp transposes the .at() arguments)."""
    dyx = np.concatenate([CIRCLE3, CIRCLE4])
    dy, dx = dyx[:, 0].tolist(), dyx[:, 1].tolist()
    if not cfg.group_track_axis_order:
        dy, dx = dx, dy
    return dy, dx


def _sliding(x: torch.Tensor, length: int, op, dim: int) -> torch.Tensor:
    """out[i] = op(x[i .. i+length-1]) along `dim`, by doubling: log2(length)
    shifted elementwise ops, output width = width - length + 1."""
    w = x.shape[dim]
    assert 1 <= length <= w, (length, w)
    p, cur = 1, x
    while 2 * p <= length:
        cur = op(cur.narrow(dim, 0, cur.shape[dim] - p), cur.narrow(dim, p, cur.shape[dim] - p))
        p *= 2
    out_w = w - length + 1
    if p < length:
        return op(cur.narrow(dim, 0, out_w), cur.narrow(dim, length - p, out_w))
    return cur.narrow(dim, 0, out_w)


def _streak_any(ring: torch.Tensor, smin: int, smax: int, dim: int = 1) -> torch.Tensor:
    """The streak test for every start and length, on rings laid out along
    `dim` ((N, R) candidates with dim=1, (R, H, W) planes with dim=0): some
    (start i, length s) with ring[i] >= ring[i-1], ring[i+s-1] >= ring[i+s]
    and min(ring[i..i+s-1]) > max(ring[i+s..i+R-1]), indices mod R."""
    r = ring.shape[dim]
    # smax == r would leave the off-arc window empty
    assert 1 <= smin <= smax < r, (smin, smax, r)
    ring2 = torch.cat([ring, ring], dim)
    cond1 = ring >= torch.roll(ring, 1, dim)
    found = None
    for s in range(smin, smax + 1):
        arc_min = _sliding(ring2, s, torch.minimum, dim).narrow(dim, 0, r)
        off_max = _sliding(ring2, r - s, torch.maximum, dim).narrow(dim, s, r)
        cond2 = ring2.narrow(dim, s - 1, r) >= ring2.narrow(dim, s, r)
        ok = (cond1 & cond2 & (off_max < arc_min)).any(dim)
        found = ok if found is None else found | ok
    return found


def streak_any_scan(ring: torch.Tensor, smin: int, smax: int,
                    lo: int | None = None, hi: int | None = None) -> torch.Tensor:
    """The per-pixel arithmetic of csrc/efast_stencil.cu on (N, R) rings,
    equal to `_streak_any`. A ring passes if some start i and length s in
    [smin, smax] give min(ring[i..i+s-1]) > max(ring[i+s..i+R-1]); the two
    end conditions of `_streak_any` follow from that one. A ring with fewer
    than smin values above its minimum is rejected first. The kernel scans
    the lengths [lo, hi] (compile-time there: [smin, smax] at the default
    bounds, else [1, R-1]), each tested against [smin, smax]: the off-arc
    maximum for length hi comes for every start from a doubling sliding
    maximum over hi's off-arc window, then per start the arc minimum grows
    and the off-arc maximum shrinks one sample per length."""
    n, r = ring.shape
    lo = smin if lo is None else lo
    hi = smax if hi is None else hi
    assert 1 <= lo <= smin <= smax <= hi < r, (lo, smin, smax, hi, r)
    above = (ring > ring.amin(1, keepdim=True)).sum(1)
    span, wmax, p = r - hi, ring, 1
    while 2 * p <= span:
        wmax = torch.maximum(wmax, torch.roll(wmax, -p, 1))   # wmax[k] = max(ring[k..k+2p-1])
        p *= 2
    # om[:, i] = max(ring[i+hi .. i+r-1])
    om = torch.maximum(torch.roll(wmax, -hi, 1), torch.roll(wmax, -(hi + span - p), 1))
    found = torch.zeros(n, dtype=torch.bool, device=ring.device)
    for i in range(r):
        rot = torch.roll(ring, -i, 1)                        # rot[:, k] = ring[:, i+k]
        arc = {lo: rot[:, :lo].amin(1)}
        for s in range(lo + 1, hi + 1):
            arc[s] = torch.minimum(arc[s - 1], rot[:, s - 1])
        off = om[:, i]
        for s in range(hi, lo - 1, -1):
            if s < hi:
                off = torch.maximum(off, rot[:, s])
            if smin <= s <= smax:
                found |= arc[s] > off
    return (above >= smin) & found


def _in_border(h: int, w: int, cfg: EFastConfig, sensor: SensorConfig,
               device) -> torch.Tensor:
    cs = cfg.border
    yy = torch.arange(h, device=device)[:, None]
    xx = torch.arange(w, device=device)[None, :]
    return (xx >= cs) & (xx < sensor.width - cs) & (yy >= cs) & (yy < sensor.height - cs)


def _band_mask(slab: torch.Tensor, bh: int, w: int, cfg: EFastConfig) -> torch.Tensor:
    """eFAST mask of a (bh, w) band from its (bh+8, w+8) halo slab: the 36
    ring planes are static slices of the slab."""
    dy, dx = _ring_offsets(cfg)
    planes = torch.stack([slab[4 + a:4 + a + bh, 4 + b:4 + b + w]
                          for a, b in zip(dy, dx)])
    n3 = len(CIRCLE3)
    f3 = _streak_any(planes[:n3], cfg.streak3_min, cfg.streak3_max, dim=0)
    f4 = _streak_any(planes[n3:], cfg.streak4_min, cfg.streak4_max, dim=0)
    return f3 & f4


def corner_mask_dense(sae: torch.Tensor, cfg: EFastConfig = EFastConfig(),
                      sensor: SensorConfig = SensorConfig()) -> torch.Tensor:
    """(H, W) bool eFAST mask of every pixel; border pixels are False."""
    h, w = sae.shape
    pad = torch.nn.functional.pad(sae, (4, 4, 4, 4))
    return _band_mask(pad, h, w, cfg) & _in_border(h, w, cfg, sensor, sae.device)


def corner_mask_dense_banded(sae: torch.Tensor, cfg: EFastConfig = EFastConfig(),
                             sensor: SensorConfig = SensorConfig(),
                             band: int = 8) -> torch.Tensor:
    """corner_mask_dense evaluated in y-bands, so intermediates stay
    band-sized."""
    h, w = sae.shape
    assert h % band == 0, (h, band)
    pad = torch.nn.functional.pad(sae, (4, 4, 4, 4))
    mask = torch.cat([_band_mask(pad[i:i + band + 8], band, w, cfg)
                      for i in range(0, h, band)])
    return mask & _in_border(h, w, cfg, sensor, sae.device)


def _check_stencil_args(sae, active, band, wtile):
    h, w = sae.shape
    kernels.check(sae, "sae", torch.int32, (h, w))
    kernels.check(active, "active", torch.bool, (-(-h // band), -(-w // wtile)))
    return kernels.check_device(sae, active)


def corner_mask_stencil_plain(sae: torch.Tensor, active: torch.Tensor,
                              cfg: EFastConfig = EFastConfig(),
                              sensor: SensorConfig = SensorConfig(),
                              band: int = 24, wtile: int = WTILE) -> torch.Tensor:
    """Plain version of `corner_mask_stencil`: the whole-surface mask with
    the pixels of inactive tiles set False."""
    _check_stencil_args(sae, active, band, wtile)
    h, w = sae.shape
    tiles = active.repeat_interleave(band, 0).repeat_interleave(wtile, 1)[:h, :w]
    return corner_mask_dense(sae, cfg, sensor) & tiles


def corner_mask_stencil(sae: torch.Tensor, active: torch.Tensor,
                        cfg: EFastConfig = EFastConfig(),
                        sensor: SensorConfig = SensorConfig(),
                        band: int = 24, wtile: int = WTILE) -> torch.Tensor:
    """Tile-predicated dense eFAST mask: (H, W) bool, False on the border
    and in tiles whose `active` flag ((ceil(H/band), ceil(W/wtile)) bool) is
    False. Counterpart of the JAX package's three Pallas stencils
    (corner_mask_dense_pallas_sparse2 / _sparse / corner_mask_dense_pallas:
    a tile map, a band map broadcast over tiles, all ones). CUDA tensors
    launch csrc/efast_stencil.cu; CPU tensors take the plain version."""
    device = _check_stencil_args(sae, active, band, wtile)
    if device < 0:
        return corner_mask_stencil_plain(sae, active, cfg, sensor, band, wtile)
    _check_streaks(cfg)
    h, w = sae.shape
    out = torch.empty((h, w), dtype=torch.bool, device=sae.device)
    kernels.launch("efast_stencil", device, sae.data_ptr(), h, w, active.data_ptr(),
                   active.shape[0], active.shape[1], band, wtile, cfg.border,
                   sensor.width, sensor.height, cfg.streak3_min, cfg.streak3_max,
                   cfg.streak4_min, cfg.streak4_max,
                   int(not cfg.group_track_axis_order), out.data_ptr())
    return out


def _pick_band(h: int) -> int:
    """Largest divisor of h among the band heights the JAX package uses."""
    for b in (24, 20, 16, 12, 10, 8, 6, 5, 4):
        if h % b == 0:
            return b
    return 0


def tile_activity(ev_y: torch.Tensor, ev_valid: torch.Tensor, h: int, w: int,
                  band: int, ev_x: torch.Tensor | None = None,
                  wtile: int = WTILE) -> torch.Tensor:
    """(ceil(H/band), ceil(W/wtile)) bool: tiles holding a valid activity
    event. Without ev_x the band map is broadcast over the column tiles.
    An amax scatter: an invalid lane must not clear a flag a valid one set."""
    nb, nwt = -(-h // band), -(-w // wtile)
    by = torch.clamp(ev_y // band, 0, nb - 1)
    if ev_x is None:
        act = torch.zeros(nb, dtype=torch.int32, device=ev_y.device).scatter_reduce(
            0, by.long(), ev_valid.to(torch.int32), "amax")
        return (act > 0)[:, None].expand(nb, nwt).contiguous()
    bx = torch.clamp(ev_x // wtile, 0, nwt - 1)
    act = torch.zeros(nb * nwt, dtype=torch.int32, device=ev_y.device).scatter_reduce(
        0, (by * nwt + bx).long(), ev_valid.to(torch.int32), "amax")
    return (act > 0).reshape(nb, nwt)


@spanned("efast")
def detect_corners_dense(sae, ev_y, ev_valid, x, y, valid,
                         cfg: EFastConfig = EFastConfig(),
                         sensor: SensorConfig = SensorConfig(),
                         ev_x=None) -> torch.Tensor:
    """Dense-backend detection: the tile-predicated mask from the activity
    events (ev_x/ev_y/ev_valid), then a look-up at the (x, y, valid)
    candidates. Every tile that holds a consulted candidate must be active;
    the pipeline passes the candidates themselves. Bit-identical to
    `detect_corners`. A height with no band divisor takes that path."""
    h, w = sae.shape
    band = _pick_band(h)
    if band == 0:
        return detect_corners(sae, x, y, valid, cfg, sensor)
    act = tile_activity(ev_y, ev_valid, h, w, band, ev_x)
    mask = corner_mask_stencil(sae, act, cfg, sensor, band)
    return mask[y.clamp(0, h - 1), x.clamp(0, w - 1)] & valid


@spanned("efast")
def detect_corners(sae: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                   valid: torch.Tensor, cfg: EFastConfig = EFastConfig(),
                   sensor: SensorConfig = SensorConfig()) -> torch.Tensor:
    """(N,) bool corner mask of candidate events against the SAE, which must
    already hold this slice's events. Border events are not candidates."""
    return _ring_test(sae[None], x[None], y[None], valid[None], cfg, sensor)[0]


@spanned("efast")
def detect_corners_stacked(saes: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                           valid: torch.Tensor, cfg: EFastConfig = EFastConfig(),
                           sensor: SensorConfig = SensorConfig()) -> torch.Tensor:
    """(Q, M) corner mask of Q snapshots' candidates at once: snapshot q
    (saes[q], (Q, H, W)) against candidates x[q], y[q], valid[q]. The stack
    is viewed as one (Q*H, W) image with each candidate's y offset by q*H;
    a ring never crosses into the next snapshot, since candidates within
    `border` of an edge are rejected first. Bit-identical to per-snapshot
    `detect_corners`."""
    return _ring_test(saes, x, y, valid, cfg, sensor)


def _candidates(x, y, valid, cfg: EFastConfig, sensor: SensorConfig) -> torch.Tensor:
    cs = cfg.border
    return valid & (x >= cs) & (x < sensor.width - cs) & (y >= cs) \
        & (y < sensor.height - cs)


def _check_streaks(cfg: EFastConfig) -> None:
    """The kernels' streak lengths must lie inside the rings."""
    if not (1 <= cfg.streak3_min <= cfg.streak3_max < len(CIRCLE3)
            and 1 <= cfg.streak4_min <= cfg.streak4_max < len(CIRCLE4)):
        raise ValueError(f"streak lengths outside the rings: {cfg}")


def _check_ring_args(saes, x, y, valid):
    q, h, w = saes.shape
    m = x.shape[-1]
    kernels.check(saes, "sae", torch.int32, (q, h, w))
    kernels.check(x, "x", torch.int32, (q, m))
    kernels.check(y, "y", torch.int32, (q, m))
    kernels.check(valid, "valid", torch.bool, (q, m))
    return kernels.check_device(saes, x, y, valid)


def _ring_test_plain(saes: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                     valid: torch.Tensor, cfg: EFastConfig,
                     sensor: SensorConfig) -> torch.Tensor:
    """Plain version of `_ring_test`: both streak tests on the 36 ring
    samples around each (x, y), gathered from the (Q*H, W) stack with the
    ring's pixels clamped into it, and the candidates' border test."""
    _check_ring_args(saes, x, y, valid)
    q, h, w = saes.shape
    sae = saes.reshape(q * h, w)
    yy = (y + (torch.arange(q, dtype=y.dtype, device=y.device) * h)[:, None]).reshape(-1)
    xx = x.reshape(-1)
    dy, dx = _ring_offsets(cfg)
    dy = torch.tensor(dy, dtype=yy.dtype, device=yy.device)
    dx = torch.tensor(dx, dtype=xx.dtype, device=xx.device)
    rows = (yy[:, None] + dy[None, :]).clamp(0, q * h - 1)
    cols = (xx[:, None] + dx[None, :]).clamp(0, w - 1)
    rings = sae[rows, cols]                                 # (Q*M, 36)
    n3 = len(CIRCLE3)
    f3 = _streak_any(rings[:, :n3], cfg.streak3_min, cfg.streak3_max)
    f4 = _streak_any(rings[:, n3:], cfg.streak4_min, cfg.streak4_max)
    return _candidates(x, y, valid, cfg, sensor) & (f3 & f4).reshape(x.shape)


def _ring_test(saes: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
               valid: torch.Tensor, cfg: EFastConfig,
               sensor: SensorConfig) -> torch.Tensor:
    """(Q, M) bool: the candidates (x[q], y[q], valid[q]) of each snapshot
    saes[q] ((Q, H, W) int32) that lie inside the sensor's border and pass
    both streak tests, the ring's pixels clamped into the (Q*H, W) stack.
    CUDA tensors launch csrc/efast_ring.cu, one launch and no sync; CPU
    tensors take the plain version. The surface's (H, W) bound the clamp,
    the sensor's width and height the border test: a tile's slab differs
    from its sensor frame (parallel/tiling.py)."""
    device = _check_ring_args(saes, x, y, valid)
    if device < 0:
        return _ring_test_plain(saes, x, y, valid, cfg, sensor)
    _check_streaks(cfg)
    q, h, w = saes.shape
    out = torch.empty(x.shape, dtype=torch.bool, device=x.device)
    if out.numel() == 0:
        return out
    kernels.launch("efast_ring", device, saes.data_ptr(), q, h, w, x.data_ptr(),
                   y.data_ptr(), valid.data_ptr(), x.shape[1], cfg.border,
                   sensor.width, sensor.height, cfg.streak3_min, cfg.streak3_max,
                   cfg.streak4_min, cfg.streak4_max,
                   int(not cfg.group_track_axis_order), out.data_ptr())
    return out
