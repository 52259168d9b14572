"""The port's spatial tiling (evflow_tpu_torch/parallel/tiling.py, NMS's
immune corners, fastcluster.update_slice_distributed and cluster_stats'
k_after) against the JAX package, on the CPU: the port on 4 Gloo ranks
(test_torch_ranks.py), JAX on a 4-device mesh of conftest's 8 CPU devices,
the same numpy inputs (tests/test_parallel.py's cases).

Tolerances: bucketing, NMS, slabs and every integer or bool field
bit-equal; cluster floats (mu, centroids, flow, ring sums) within rtol
1e-5, atol 1e-3 (the per-tile partial sums reorder the f32 sums, as the JAX
package's own equivalence test allows); tracker floats within rtol 1e-5,
atol 1e-4 (norms and small sums in another order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from evflow_tpu import config as jconfig
from evflow_tpu.models import fastcluster as jfastcluster
from evflow_tpu.ops import nms as jnms
from evflow_tpu.parallel import tiling as jtiling
from evflow_tpu_torch import config, interop
from evflow_tpu_torch.models import fastcluster
from evflow_tpu_torch.ops import cluster_kernels, hash_dedup, nms
from evflow_tpu_torch.parallel import tiling

import test_torch_ranks as R

CLUSTER_TOL = dict(rtol=1e-5, atol=1e-3)
TRACK_TOL = dict(rtol=1e-5, atol=1e-4)


def jax_mesh():
    return Mesh(np.array(jax.devices()[:R.N_TILES]), ("tile",))


def assert_saved_close(got: dict, prefix: str, want_tree, rtol, atol, skip=()):
    """Every leaf of want_tree (either package) against the rank's saved
    array of the same name: integers and bools equal, floats within
    rtol/atol."""
    for name, want in interop.named_leaves(want_tree, prefix):
        if name in skip:
            continue
        a = got[name]
        assert a.dtype == want.dtype and a.shape == want.shape, (name, a.dtype, a.shape,
                                                                 want.dtype, want.shape)
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, want, rtol=rtol, atol=atol, err_msg=name)
        else:
            np.testing.assert_array_equal(a, want, err_msg=name)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return R.run_ranks(R.tiling_rank, R.N_TILES, tmp_path_factory.mktemp("tiling"))


# --------------------------------------------------------------- bucketing

@pytest.mark.parametrize("capacity", [40, 512])
def test_bucketing_equals_the_jax_package(capacity):
    rng = np.random.default_rng(5)
    s, n, width = 6, 200, 256
    x = rng.integers(0, width, (s, n)).astype(np.int32)
    y = rng.integers(0, 128, (s, n)).astype(np.int32)
    t = np.sort(rng.integers(0, 10**6, (s, n)), axis=1).astype(np.int64)
    p = rng.integers(0, 2, (s, n)).astype(np.int32)
    valid = rng.random((s, n)) < 0.9
    ours = tiling.bucket_slices_by_tile(x, y, t, p, valid, R.N_TILES, width, capacity)
    theirs = jtiling.bucket_slices_by_tile(x, y, t, p, valid, R.N_TILES, width, capacity)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
    for i in range(s):
        one = tiling.bucket_by_tile(x[i], y[i], t[i], p[i], valid[i], R.N_TILES, width,
                                    capacity)
        jone = jtiling.bucket_by_tile(x[i], y[i], t[i], p[i], valid[i], R.N_TILES, width,
                                      capacity)
        for a, b, c in zip(one, jone, ours):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c[i].astype(a.dtype))


# ----------------------------------------------------- NMS's immune corners

def _nms_case(seed):
    rng = np.random.default_rng(seed)
    c, m = 48, 12
    x = rng.integers(0, 60, c).astype(np.int32)
    y = rng.integers(0, 40, c).astype(np.int32)
    v = rng.random(c) < 0.8
    ix = rng.integers(0, 60, m).astype(np.int32)
    iy = rng.integers(0, 40, m).astype(np.int32)
    iv = rng.random(m) < 0.6
    return x, y, v, ix, iy, iv


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_nms_with_immune_corners_equals_the_jax_package(seed):
    x, y, v, ix, iy, iv = _nms_case(seed)
    cfg, jcfg = config.NMSConfig(), jconfig.NMSConfig()
    imm = [torch.as_tensor(a) for a in (ix, iy, iv)]
    jimm = [jnp.asarray(a) for a in (ix, iy, iv)]
    acc, count = nms.accept_corners(*(torch.as_tensor(a) for a in (x, y, v)), cfg, *imm)
    jacc, jcount = jnms.accept_corners(*(jnp.asarray(a) for a in (x, y, v)), jcfg, *jimm)
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
    assert int(count) == int(jcount)
    got = nms.filter_corners(*(torch.as_tensor(a) for a in (x, y, v)), cfg, *imm)
    want = jnms.filter_corners(*(jnp.asarray(a) for a in (x, y, v)), jcfg, *jimm)
    interop.assert_trees_close(got, want, 0, 0)
    # the immune corners suppress: fewer accepted than without them
    assert int(count) < int(nms.accept_corners(*(torch.as_tensor(a) for a in (x, y, v)),
                                               cfg)[1])


def _jax_chain(rounds):
    """JAX's tile_local_nms on the adversarial chain, as
    tests/test_parallel.py runs it: (N_TILES, cap) x and survivor mask."""
    px, py, pv = R.nms_chain_inputs()
    cfg = R.nms_chain_cfg(jconfig, rounds)
    axis = cfg.parallel.tile_axis

    def per_tile(x, y, v):
        my = jax.lax.axis_index(axis)
        filt = jtiling.tile_local_nms(x[0], y[0], v[0], axis, my, R.N_TILES,
                                      my * R.TILE_W, R.TILE_W, cfg)
        return filt.x[None], filt.count[None]

    sm = shard_map(per_tile, mesh=jax_mesh(), in_specs=(P(axis), P(axis), P(axis)),
                   out_specs=(P(axis), P(axis)), check_vma=False)
    fx, cnt = jax.jit(sm)(jnp.asarray(px), jnp.asarray(py), jnp.asarray(pv))
    return np.asarray(fx), np.asarray(cnt)


def _survivors(fx, cnt):
    return sorted(int(v) for k in range(R.N_TILES) for v in fx[k][:cnt[k]])


@pytest.mark.parametrize("rounds", [2, R.N_TILES])
def test_adversarial_nms_chain_equals_the_jax_package(ranks, rounds):
    """The two-pass tile-local NMS deviates from the replicated greedy on
    the chain exactly as JAX's does, and N_TILES rounds close it."""
    jx, jcnt = _jax_chain(rounds)
    fx = np.stack([r[f"nms{rounds}.0"] for r in ranks])
    cnt = np.array([int(r[f"nms{rounds}.1"]) for r in ranks])
    np.testing.assert_array_equal(fx, jx)
    np.testing.assert_array_equal(cnt, jcnt)
    # ground truth: the replicated greedy over the tile-major concatenation
    px, py, pv = R.nms_chain_inputs()
    keep = pv.reshape(-1)
    gx, gy = px.reshape(-1)[keep], py.reshape(-1)[keep]
    ref = nms.filter_corners(torch.as_tensor(gx), torch.as_tensor(gy),
                             torch.ones(len(gx), dtype=torch.bool), config.NMSConfig(box_size=15))
    truth = sorted(ref.x[:int(ref.count)].tolist())
    if rounds == 2:
        assert _survivors(fx, cnt) != truth
    else:
        assert _survivors(fx, cnt) == truth


# ------------------------------------------------- the tiled cluster update

@pytest.fixture(scope="module")
def jax_cluster_steps():
    cfg = R.tile_cfg(jconfig)
    m = jax_mesh()
    step = jtiling.make_tiled_cluster_flow_step(m, cfg)
    ts = NamedSharding(m, P("tile"))
    st = jfastcluster.init_state(cfg.cluster)
    outs = []
    for x, y, v in R.tile_cluster_inputs():
        st, out, uc, rc = step(st, *(jax.device_put(jnp.asarray(a), ts) for a in (x, y, v)))
        outs.append(jax.device_get((st, out, uc, rc)))
    return outs


@pytest.mark.parametrize("s", range(4))
def test_tiled_cluster_step_equals_the_jax_package(ranks, jax_cluster_steps, s):
    st, out, uc, rc = jax_cluster_steps[s]
    cap = R.tile_cluster_inputs()[0][0].shape[1]
    for k, got in enumerate(ranks):
        assert_saved_close(got, f"cl{s}", (st, out._replace(labels=out.labels[:0]), uc, rc),
                           **CLUSTER_TOL, skip=(f"cl{s}.1.labels",))
        np.testing.assert_array_equal(got[f"cl{s}.1.labels"],
                                      np.asarray(out.labels)[k * cap:(k + 1) * cap])
    assert int(np.asarray(out.reported).sum()) >= R.N_TILES   # a blob per tile


def test_tiled_cluster_step_with_hash_dedup_equals_the_jax_package(ranks):
    """tests/test_parallel.py's first case: one blob per tile, hash dedup
    with a table per tile. Each tile's cluster is reported, and the tiles
    count at least the unique events of one table over the concatenation
    (per-tile tables split hash collisions)."""
    cfg = R.tile_hash_cfg(jconfig)
    m = jax_mesh()
    ts = NamedSharding(m, P("tile"))
    st, out, uc, rc = jax.device_get(jtiling.make_tiled_cluster_flow_step(m, cfg)(
        jfastcluster.init_state(cfg.cluster),
        *(jax.device_put(jnp.asarray(a), ts) for a in R.tile_hash_inputs())))
    cap = out.labels.shape[0] // R.N_TILES
    for k, got in enumerate(ranks):
        assert_saved_close(got, "hash", (st, out._replace(labels=out.labels[:0]), uc, rc),
                           **CLUSTER_TOL, skip=("hash.1.labels",))
        np.testing.assert_array_equal(got["hash.1.labels"],
                                      np.asarray(out.labels)[k * cap:(k + 1) * cap])
    assert int(ranks[0]["hash.1.reported"].sum()) == R.N_TILES
    x, y, v = (torch.as_tensor(a.reshape(-1)) for a in R.tile_hash_inputs())
    tcfg = R.tile_hash_cfg(config)
    assert int(ranks[0]["hash.2"]) >= int(hash_dedup.dedup(x, y, v, tcfg.dedup,
                                                            tcfg.sensor).unique_count)


def test_tiled_cluster_step_equals_update_slice_on_the_concatenation(ranks):
    """tests/test_parallel.py's property: the tiled update equals the
    one-rank update on the tile-major concatenation of the tiles' events
    (exact dedup, so per-tile masks equal the global mask), slice after
    slice from the same fresh state."""
    cfg = R.tile_cfg(config)
    st = fastcluster.init_state(cfg.cluster, device="cpu")
    for s, (x, y, v) in enumerate(R.tile_cluster_inputs()):
        xx, yy, vv = (torch.as_tensor(a.reshape(-1)) for a in (x, y, v))
        ded = hash_dedup.dedup_mask(xx, yy, vv, cfg.dedup, cfg.sensor)
        st, out = fastcluster.update_slice(st, xx, yy, ded.unique_mask, cfg.cluster,
                                           cfg.sensor)
        got = ranks[0]
        assert int(got[f"cl{s}.2"]) == int(ded.unique_count)
        for name, leaf in interop.named_leaves((st, out._replace(labels=out.labels[:0]))):
            saved = got[f"cl{s}{name}"] if not name.endswith("labels") else None
            if saved is None:
                continue
            if leaf.dtype.kind == "f":
                np.testing.assert_allclose(saved, leaf, **CLUSTER_TOL, err_msg=name)
            else:
                np.testing.assert_array_equal(saved, leaf, err_msg=name)
        cap = x.shape[1]
        labels = np.concatenate([r[f"cl{s}.1.labels"] for r in ranks])
        np.testing.assert_array_equal(labels, out.labels.numpy())
        assert cap * R.N_TILES == labels.shape[0]


def test_replicated_state_is_bit_identical_on_every_rank(ranks):
    for got in ranks[1:]:
        for name, a in got.items():
            if name.endswith("labels") or name.startswith(("nms", "co_final.0")):
                continue          # per-rank: local labels, survivors, slabs
            np.testing.assert_array_equal(a, ranks[0][name], err_msg=name)


# ------------------------------------------- cluster_stats' later-tile counts

def test_cluster_stats_k_after_continues_the_ranks_into_later_tiles():
    """cluster_stats_plain per tile with k_after (the later tiles' member
    counts), summed over the tiles, equals cluster_stats_plain on the
    tile-major concatenation: counts exact, sums within f32 order; k_after
    of zeros gives the same bits as none."""
    rng = np.random.default_rng(2)
    c, alpha = 24, 0.5
    tiles = []
    for _ in range(R.N_TILES):
        n = int(rng.integers(50, 300))
        tiles.append((torch.as_tensor(rng.integers(-1, c, n).astype(np.int32)),
                      torch.as_tensor(rng.uniform(0, 256, n).astype(np.float32)),
                      torch.as_tensor(rng.uniform(0, 128, n).astype(np.float32))))
    counts = [torch.bincount(lab[lab >= 0].long(), minlength=c).to(torch.int32)
              for lab, _, _ in tiles]
    total = torch.zeros((c, 5))
    for k, (lab, x, y) in enumerate(tiles):
        k_after = torch.stack(counts[k + 1:]).sum(0, dtype=torch.int32) \
            if k + 1 < len(tiles) else torch.zeros(c, dtype=torch.int32)
        part = cluster_kernels.cluster_stats(lab, x, y, alpha, c, k_after)
        np.testing.assert_array_equal(part[:, 0].numpy(), counts[k].numpy())
        total += part
    whole = cluster_kernels.cluster_stats(*(torch.cat(a) for a in zip(*tiles)), alpha, c)
    np.testing.assert_array_equal(total[:, 0].numpy(), whole[:, 0].numpy())
    np.testing.assert_allclose(total.numpy(), whole.numpy(), **CLUSTER_TOL)
    lab, x, y = tiles[0]
    assert torch.equal(cluster_kernels.cluster_stats_plain(lab, x, y, alpha, c),
                       cluster_kernels.cluster_stats_plain(
                           lab, x, y, alpha, c, torch.zeros(c, dtype=torch.int32)))
    with pytest.raises(TypeError):
        cluster_kernels.cluster_stats(lab, x, y, alpha, c, torch.zeros(c))


# --------------------------------------------------- the tiled corner step

@pytest.fixture(scope="module")
def jax_corner_steps():
    cfg = R.scene_cfg(jconfig)
    m = jax_mesh()
    step = jtiling.make_tiled_corner_step(m, R.N_TILES, cfg)
    ts = NamedSharding(m, P("tile"))
    slab, tracks, idx = jtiling.init_tiled_corner_state(m, R.N_TILES, cfg)
    outs = []
    for ev in zip(*R.corner_tile_inputs()):
        slab, tracks, idx, out = step(slab, tracks, idx,
                                      *(jax.device_put(jnp.asarray(a), ts) for a in ev))
        outs.append(jax.device_get(out))
    return outs, jax.device_get((slab, tracks, idx))


def test_tiled_corner_step_equals_the_jax_package(ranks, jax_corner_steps):
    outs, (slab, tracks, idx) = jax_corner_steps
    assert sum(int(o.num_corners) for o in outs) > 0
    for s, out in enumerate(outs):
        for got in ranks:
            assert_saved_close(got, f"co{s}", out, **TRACK_TOL)
    for k, got in enumerate(ranks):
        np.testing.assert_array_equal(got["co_final.0"], np.asarray(slab)[k])
        assert_saved_close(got, "co_final", (slab[k], tracks, idx), **TRACK_TOL,
                           skip=("co_final.0",))


def test_interop_carries_tiled_states_both_ways(jax_cluster_steps, jax_corner_steps):
    """from_jax carries the tiled paths' states (FastState, the tiled corner
    state's tracks) into the port, leaf for leaf, and back."""
    from evflow_tpu_torch.models import tracker
    jst = jax_cluster_steps[-1][0]
    jtracks = jax_corner_steps[1][1]
    cfg = R.scene_cfg(config)
    for template, state in ((fastcluster.init_state(R.tile_cfg(config).cluster, device="cpu"),
                             jst),
                            (tracker.init_state(cfg.tracker, device="cpu"), jtracks)):
        ported = interop.from_jax(template, state)
        interop.assert_trees_close(ported, state, 0, 0)
        back = type(state)(*(jnp.asarray(a) for a in interop.to_leaves(ported)))
        interop.assert_trees_close(back, state, 0, 0)
