"""Parity of the PyTorch port's per-slice operators with the JAX package:
dedup (one slice, batched and sorted), SAE and its render, eFAST
(per-candidate, dense masks, the dense detector) and NMS.
Inputs are made with numpy from a seed and go through both packages; every
result here is integer or boolean and must be bit-equal. The dense masks
are also held against the JAX package's Pallas stencils in interpret mode
and against its scalar-loop numpy oracle.

The CUDA stencil itself runs only on a card (`-m cuda`, see README)."""

import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from evflow_tpu.config import DedupConfig, EFastConfig, NMSConfig, SensorConfig
from evflow_tpu.ops import efast as jefast, hash_dedup as jdedup
from evflow_tpu.ops import nms as jnms, sae as jsae
from evflow_tpu_torch import kernels
from evflow_tpu_torch.ops import efast, hash_dedup, nms, sae

torch.set_num_threads(2)

H, W = 120, 256
SENSOR = SensorConfig(width=W, height=H)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _events(rng, n, width=W, height=H, out_of_range=True):
    x = rng.integers(0, width, n).astype(np.int32)
    y = rng.integers(0, height, n).astype(np.int32)
    if out_of_range:
        # the inclusive-range quirk (x == width admitted) and negatives
        x[:8] = width
        y[8:16] = height
        x[16:20] = -1
        y[20:24] = -3
    v = rng.random(n) < 0.85
    return x, y, v


def _surface(rng, h=H, w=W):
    """Wedges of recent timestamps over a sparse older background."""
    sae_ = np.zeros((h, w), np.int32)
    for ax, ay, t0 in ((40, 40, 100), (100, 80, 200), (200, 30, 300),
                       (130, 100, 400)):
        sae_[ay - 10:ay + 1, ax - 10:ax + 1] = rng.integers(t0, t0 + 50, (11, 11))
    nz = rng.random((h, w)) < 0.08
    sae_[nz] = rng.integers(1, 90, nz.sum())
    return sae_


@pytest.mark.parametrize("exact", [False, True])
def test_dedup_mask_matches_jax(exact):
    rng = np.random.default_rng(1)
    cfg = DedupConfig(exact=exact, num_buckets=512)
    x, y, v = _events(rng, 2048)
    got = hash_dedup.dedup_mask(_t(x), _t(y), _t(v), cfg, SENSOR)
    want = jdedup.dedup_mask(jnp.asarray(x), jnp.asarray(y), jnp.asarray(v),
                             cfg, SENSOR)
    for g, w_ in zip(got, want):
        _eq(g, w_)
    assert int(got.repeated_count) > 0


def test_dedup_compaction_matches_jax_and_oracle():
    rng = np.random.default_rng(2)
    cfg = DedupConfig()
    x, y, v = _events(rng, 1024)
    got = hash_dedup.dedup(_t(x), _t(y), _t(v), cfg, SENSOR)
    want = jdedup.dedup(jnp.asarray(x), jnp.asarray(y), jnp.asarray(v), cfg, SENSOR)
    for g, w_ in zip(got, want):
        _eq(g, w_)
    uniques, repeated = jdedup.dedup_reference_numpy(x[v], y[v], cfg, SENSOR)
    k = int(got.unique_count)
    assert list(zip(got.unique_x[:k].tolist(), got.unique_y[:k].tolist())) == uniques
    assert int(got.repeated_count) == repeated


def _same_result(got, want):
    for name, g, w_ in zip(want._fields, got, want):
        assert g.numpy().dtype == np.asarray(w_).dtype, name
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_), err_msg=name)


@pytest.mark.parametrize("exact", [False, True])
def test_dedup_batched_matches_jax_vmap(exact):
    """One batched sort over (S, N) against JAX's vmap of dedup, and each
    row against the port's own dedup."""
    rng = np.random.default_rng(11)
    cfg = DedupConfig(exact=exact, num_buckets=512)
    rows = [_events(rng, 1536) for _ in range(5)]
    x, y, v = (np.stack(a) for a in zip(*rows))
    v[2] = False                                     # an empty slice
    got = hash_dedup.dedup_batched(_t(x), _t(y), _t(v), cfg, SENSOR)
    _same_result(got, jdedup.dedup_batched(jnp.asarray(x), jnp.asarray(y),
                                           jnp.asarray(v), cfg, SENSOR))
    for s in range(5):
        one = hash_dedup.dedup(_t(x[s]), _t(y[s]), _t(v[s]), cfg, SENSOR)
        for g, w_ in zip(one, got):
            assert torch.equal(g, w_[s])
    assert int(got.unique_count[2]) == 0 and bool((got.repeated_count > 0).any())


@pytest.mark.parametrize("exact", [False, True])
def test_dedup_sorted_matches_jax(exact):
    rng = np.random.default_rng(12)
    cfg = DedupConfig(exact=exact, num_buckets=512)
    x, y, v = _events(rng, 2048)
    got = hash_dedup.dedup_sorted(_t(x), _t(y), _t(v), cfg, SENSOR)
    _same_result(got, jdedup.dedup_sorted(jnp.asarray(x), jnp.asarray(y), jnp.asarray(v),
                                          cfg, SENSOR))
    assert int(got.repeated_count) > 0


@pytest.mark.parametrize("delta_ts", [10_000, 777, 3])
def test_render_time_surface_matches_jax(delta_ts):
    """fp32, the division IEEE-rounded, then uint8: bit-equal."""
    rng = np.random.default_rng(13)
    surface = rng.integers(0, 50_000, (H, W)).astype(np.int32)
    surface[rng.random((H, W)) < 0.3] = 0
    for last in (50_000, 43_210, 7):
        last_t = np.int32(last)
        got = sae.render_time_surface(_t(surface), torch.tensor(last_t), delta_ts)
        want = jsae.render_time_surface(jnp.asarray(surface), jnp.asarray(last_t), delta_ts)
        assert got.dtype == torch.uint8
        _eq(got, want)


def test_update_sae_matches_jax():
    """Scatter-max with JAX's drop rule: negatives wrap once, anything still
    out of range (x == width, y == height) is dropped, invalid lanes write
    nothing."""
    rng = np.random.default_rng(3)
    x, y, v = _events(rng, 2048)
    x[24:28] = -W - 2          # beyond one wrap: dropped
    base = rng.integers(0, 500, (H, W)).astype(np.int32)
    t = np.sort(rng.integers(200, 5000, 2048)).astype(np.int32)
    got = sae.update_sae(_t(base), _t(x), _t(y), _t(t), _t(v))
    want = jsae.update_sae(jnp.asarray(base), jnp.asarray(x), jnp.asarray(y),
                           jnp.asarray(t), jnp.asarray(v))
    _eq(got, want)
    _eq(sae.last_time(_t(t), _t(v)), jsae.last_time(jnp.asarray(t), jnp.asarray(v)))
    _eq(sae.init_sae(SENSOR, device="cpu"), jsae.init_sae(SENSOR))


@pytest.mark.parametrize("axis_order", [True, False])
def test_detect_corners_matches_jax_and_oracle(axis_order):
    rng = np.random.default_rng(4)
    cfg = EFastConfig(group_track_axis_order=axis_order)
    sae_ = _surface(rng)
    x, y, v = _events(rng, 2048, out_of_range=False)
    got = efast.detect_corners(_t(sae_), _t(x), _t(y), _t(v), cfg, SENSOR)
    want = jefast.detect_corners(jnp.asarray(sae_), jnp.asarray(x), jnp.asarray(y),
                                 jnp.asarray(v), cfg, SENSOR)
    _eq(got, want)
    assert int(got.sum()) > 0
    oracle = jefast.detect_corners_reference_numpy(sae_, x, y, cfg, SENSOR)
    _eq(got, oracle & v)


@pytest.mark.parametrize("axis_order", [True, False])
def test_ring_test_on_cpu_takes_plain_version(axis_order):
    """`_ring_test` on CPU tensors is its plain version, launches nothing,
    and equals JAX's detect_corners and its numpy oracle, one snapshot and
    a stack of two alike."""
    rng = np.random.default_rng(6)
    cfg = EFastConfig(group_track_axis_order=axis_order)
    saes = np.stack([_surface(rng), _surface(rng)])
    xs, ys, vs = zip(*[_events(rng, 1024, out_of_range=False) for _ in range(2)])
    before = kernels.LAUNCHES["efast_ring"]
    got = efast._ring_test(_t(saes), _t(np.stack(xs)), _t(np.stack(ys)), _t(np.stack(vs)),
                           cfg, SENSOR)
    assert kernels.LAUNCHES["efast_ring"] == before
    assert got.shape == (2, 1024) and int(got.sum()) > 0
    _eq(got, efast._ring_test_plain(_t(saes), _t(np.stack(xs)), _t(np.stack(ys)),
                                    _t(np.stack(vs)), cfg, SENSOR))
    for k in range(2):
        _eq(got[k], jefast.detect_corners(jnp.asarray(saes[k]), jnp.asarray(xs[k]),
                                          jnp.asarray(ys[k]), jnp.asarray(vs[k]), cfg, SENSOR))
        _eq(got[k], jefast.detect_corners_reference_numpy(saes[k], xs[k], ys[k], cfg, SENSOR)
            & vs[k])


def _ring_args(case):
    """(saes, x, y, valid) of one bad call: each breaks one of the checks."""
    saes = torch.zeros((1, H, W), dtype=torch.int32)
    x = torch.full((1, 64), 10, dtype=torch.int32)
    y, v = x.clone(), torch.ones((1, 64), dtype=torch.bool)
    if case == "sae-dtype":
        saes = saes.to(torch.int64)
    elif case == "x-dtype":
        x = x.to(torch.int64)
    elif case == "valid-dtype":
        v = v.to(torch.int32)
    elif case == "sae-not-contiguous":
        saes = torch.zeros((1, W, H), dtype=torch.int32).transpose(1, 2)
    elif case == "y-not-contiguous":
        y = torch.full((1, 128), 10, dtype=torch.int32)[:, ::2]
    elif case == "lengths":
        y = y[:, :63].contiguous()
    elif case == "valid-lengths":
        v = torch.ones((1, 65), dtype=torch.bool)
    elif case == "snapshots":
        x, y, v = (torch.cat([a, a]) for a in (x, y, v))
    return saes, x, y, v


@pytest.mark.parametrize("case,error", [
    ("sae-dtype", TypeError), ("x-dtype", TypeError), ("valid-dtype", TypeError),
    ("sae-not-contiguous", ValueError), ("y-not-contiguous", ValueError),
    ("lengths", ValueError), ("valid-lengths", ValueError), ("snapshots", ValueError)])
def test_ring_test_checks_raise_before_a_launch(case, error):
    """The ring test's checks, which run before its kernel's launch, on CPU
    tensors: the check function itself, the wrapper and the detector."""
    args = _ring_args(case)
    before = kernels.LAUNCHES["efast_ring"]
    with pytest.raises(error):
        efast._check_ring_args(*args)
    with pytest.raises(error):
        efast._ring_test(*args, EFastConfig(), SENSOR)
    assert kernels.LAUNCHES["efast_ring"] == before
    efast._check_ring_args(*_ring_args("none"))


def test_ring_kernel_offsets_are_the_circles():
    """csrc/efast_ring.cu's compile-time ring offsets are CIRCLE3 then
    CIRCLE4 in group_track order."""
    src = (Path(efast.__file__).parents[1] / "csrc" / "efast_ring.cu").read_text()
    want = np.concatenate([efast.CIRCLE3, efast.CIRCLE4])
    for k, name in enumerate(("ring_dy", "ring_dx")):
        body = re.search(name + r"\(int k\) \{.*?\{(.*?)\};", src, re.S).group(1)
        _eq([int(v) for v in body.split(",")], want[:, k])


def test_dense_masks_match_jax_pallas_stencils():
    """The stencil's plain version with an all-ones map, a band map and a
    tile map against the three Pallas stencils it stands for (interpret
    mode), and the whole-surface masks against JAX's."""
    rng = np.random.default_rng(5)
    cfg = EFastConfig()
    sae_ = _surface(rng)
    sj, st = jnp.asarray(sae_), _t(sae_)
    band = efast._pick_band(H)
    nb, nwt = H // band, W // efast.WTILE

    full = efast.corner_mask_dense(st, cfg, SENSOR)
    _eq(full, jefast.corner_mask_dense(sj, cfg, SENSOR))
    _eq(efast.corner_mask_dense_banded(st, cfg, SENSOR),
        jefast.corner_mask_dense_banded(sj, cfg, SENSOR))
    assert int(full.sum()) > 0

    ones = torch.ones((nb, nwt), dtype=torch.bool)
    _eq(efast.corner_mask_stencil(st, ones, cfg, SENSOR, band),
        jefast.corner_mask_dense_pallas(sj, cfg, SENSOR, band=band, interpret=True))

    bands = rng.random(nb) < 0.5
    bands[0] = True
    got = efast.corner_mask_stencil(
        st, _t(bands)[:, None].expand(nb, nwt).contiguous(), cfg, SENSOR, band)
    _eq(got, jefast.corner_mask_dense_pallas_sparse(
        sj, jnp.asarray(bands), cfg, SENSOR, band=band, interpret=True))

    tiles = rng.random((nb, nwt)) < 0.5
    got = efast.corner_mask_stencil(st, _t(tiles), cfg, SENSOR, band)
    _eq(got, jefast.corner_mask_dense_pallas_sparse2(
        sj, jnp.asarray(tiles), cfg, SENSOR, band=band, wtile=efast.WTILE,
        interpret=True))


@pytest.mark.parametrize("with_ev_x", [True, False])
def test_detect_corners_dense_matches_jax(with_ev_x):
    rng = np.random.default_rng(6)
    cfg = EFastConfig()
    sae_ = _surface(rng)
    x, y, v = _events(rng, 2048, out_of_range=False)
    ev_x = _t(x) if with_ev_x else None
    got = efast.detect_corners_dense(_t(sae_), _t(y), _t(v), _t(x), _t(y), _t(v),
                                     cfg, SENSOR, ev_x=ev_x)
    want = jefast.detect_corners_dense(
        jnp.asarray(sae_), jnp.asarray(y), jnp.asarray(v), jnp.asarray(x),
        jnp.asarray(y), jnp.asarray(v), cfg, SENSOR,
        ev_x=jnp.asarray(x) if with_ev_x else None)
    _eq(got, want)
    _eq(got, efast.detect_corners(_t(sae_), _t(x), _t(y), _t(v), cfg, SENSOR))
    assert int(got.sum()) > 0


def test_tile_activity_keeps_flags_of_valid_lanes():
    """Invalid lanes in a tile must not clear the flag a valid lane set."""
    ey = torch.tensor([5, 5, 50, 119], dtype=torch.int32)
    ex = torch.tensor([3, 4, 200, 255], dtype=torch.int32)
    ev = torch.tensor([True, False, False, True])
    act = efast.tile_activity(ey, ev, H, W, 24, ex)
    want = torch.zeros((5, 2), dtype=torch.bool)
    want[0, 0] = want[4, 1] = True
    assert torch.equal(act, want)
    bands = efast.tile_activity(ey, ev, H, W, 24)
    assert torch.equal(bands, want.any(1, keepdim=True).expand(5, 2))


def test_nms_matches_jax_and_oracle():
    rng = np.random.default_rng(7)
    cfg = NMSConfig(max_corners=256)
    c = cfg.max_corners
    x = rng.integers(0, 200, c).astype(np.int32)
    y = rng.integers(0, 100, c).astype(np.int32)
    v = rng.random(c) < 0.8
    got = nms.filter_corners(_t(x), _t(y), _t(v), cfg)
    want = jnms.filter_corners(jnp.asarray(x), jnp.asarray(y), jnp.asarray(v), cfg)
    for g, w_ in zip(got, want):
        _eq(g, w_)
    acc, count = nms.accept_corners(_t(x), _t(y), _t(v), cfg)
    _eq(acc, want.accepted)
    assert int(count) == int(want.count) > 1
    ref = jnms.filter_corners_reference_numpy(x[v], y[v], 200, 100, cfg)
    k = int(got.count)
    assert list(zip(got.x[:k].tolist(), got.y[:k].tolist())) == ref


def _rings(kind, r, smin, smax, rng, n=400):
    """Rings of one kind: many ties, all equal, all zero, or an arc planted
    at exactly smin or smax samples (its minimum tied with the off-arc
    maximum on every fourth ring, where it must not pass)."""
    if kind == "ties":
        return rng.integers(0, 4, (n, r))
    if kind == "all-equal":
        return np.full((n, r), 7)
    if kind == "all-zero":
        return np.zeros((n, r), np.int64)
    s = smin if kind == "arc-at-smin" else smax
    ring = rng.integers(0, 50, (n, r))
    for k in range(n):
        idx = (rng.integers(0, r) + np.arange(s)) % r
        ring[k, idx] = 100 + rng.integers(0, 3, s)
        if k % 4 == 0:
            ring[k, idx[rng.integers(0, s)]] = 49
            ring[k, (idx[-1] + 1) % r] = 49
    return ring


@pytest.mark.parametrize("kind", ["ties", "all-equal", "all-zero", "arc-at-smin", "arc-at-smax"])
@pytest.mark.parametrize("r,smin,smax", [(16, 3, 6), (20, 4, 8), (16, 1, 15), (20, 5, 5)])
def test_streak_scan_matches_plain_and_jax(kind, r, smin, smax):
    """The stencil kernel's arithmetic (efast.streak_any_scan) against the
    port's and the JAX package's _streak_any, scanning exactly [smin, smax]
    (the kernel at the default bounds) and [1, R-1] (its other bounds)."""
    rng = np.random.default_rng(r * 100 + smin * 10 + smax)
    ring = _rings(kind, r, smin, smax, rng).astype(np.int32)
    want = efast._streak_any(_t(ring), smin, smax)
    _eq(want, jefast._streak_any(jnp.asarray(ring), smin, smax))
    for lo, hi in ((smin, smax), (1, r - 1)):
        _eq(efast.streak_any_scan(_t(ring), smin, smax, lo, hi), want)
    if kind.startswith("arc"):
        assert 0 < int(want.sum()) < len(ring)
    if kind in ("all-equal", "all-zero"):
        assert int(want.sum()) == 0


@pytest.mark.parametrize("axis_order", [True, False])
def test_streak_scan_on_surface_rings(axis_order):
    """Both rings of every interior pixel of a surface, gathered in either
    axis order: the scan gives the dense mask."""
    rng = np.random.default_rng(8)
    cfg = EFastConfig(group_track_axis_order=axis_order)
    sae_ = _t(_surface(rng))
    dy, dx = efast._ring_offsets(cfg)
    yy, xx = torch.meshgrid(torch.arange(4, H - 4), torch.arange(4, W - 4), indexing="ij")
    rings = sae_[yy.reshape(-1, 1) + torch.tensor(dy), xx.reshape(-1, 1) + torch.tensor(dx)]
    n3 = len(efast.CIRCLE3)
    got = (efast.streak_any_scan(rings[:, :n3], cfg.streak3_min, cfg.streak3_max)
           & efast.streak_any_scan(rings[:, n3:], cfg.streak4_min, cfg.streak4_max))
    want = efast.corner_mask_dense(sae_, cfg, SENSOR)[4:H - 4, 4:W - 4].reshape(-1)
    _eq(got, want)
    assert int(want.sum()) > 0
