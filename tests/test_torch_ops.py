"""Parity of the PyTorch port's per-slice operators with the JAX package:
dedup, SAE, eFAST (per-candidate, dense masks, the dense detector) and NMS.
Inputs are made with numpy from a seed and go through both packages; every
result here is integer or boolean and must be bit-equal. The dense masks
are also held against the JAX package's Pallas stencils in interpret mode
and against its scalar-loop numpy oracle.

The CUDA stencil itself runs only on a card (`-m cuda`, see README)."""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from evflow_tpu.config import DedupConfig, EFastConfig, NMSConfig, SensorConfig
from evflow_tpu.ops import efast as jefast, hash_dedup as jdedup
from evflow_tpu.ops import nms as jnms, sae as jsae
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
    _eq(sae.init_sae(SENSOR), jsae.init_sae(SENSOR))


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
