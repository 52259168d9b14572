"""The port's spatio-temporal layer under Gloo ranks, shared by the parity
tests (test_torch_tiling.py, test_torch_temporal.py), which hold what the
ranks save against the JAX package; this file imports no JAX, so a spawned
rank does not either.

- The scenes and configurations of tests/test_parallel.py and
  tests/test_temporal.py, as numpy arrays made from their seeds and as
  configs of either package (`config` is the package's config module).
- `run_ranks(target, size, tmp_path)`: `target(rank, size, store, out)` on
  `size` ranks, each a spawned process joined by a FileStore, as
  test_torch_batch.py spawns them; each rank saves an npz of named arrays.
- `tiling_rank` and `temporal_rank`: what the ranks run.
- Its own tests: the mesh outside a process group and in a group of one.
"""

import dataclasses
import multiprocessing as mp

import numpy as np
import pytest
import torch

RANK_TIMEOUT_S = 240


# --------------------------------------------------------------------------
# scenes and configurations
# --------------------------------------------------------------------------

def scene_cfg(config):
    """tests/test_temporal.py's _SCENE configuration."""
    return config.EngineConfig(
        sensor=config.SensorConfig(width=256, height=128),
        slicing=config.SliceConfig(n_events=2048),
        dedup=config.DedupConfig(exact=True),
        cluster=config.ClusterConfig(max_clusters=16, radius=15.0, min_n=3),
        tracker=config.TrackerConfig(max_tracks=32, history=6, frames_to_skip=3,
                                     max_frames=60, group_radius=60.0),
        nms=config.NMSConfig(max_corners=64))


def scene(num_slices=12, n=2048, seed=0):
    """A 90-degree wedge apex moving right at 6 px/slice (a persistent eFAST
    corner) and a gaussian blob moving down (the cluster target): (x, y, t,
    p) arrays and the apex and blob positions per slice."""
    rng = np.random.default_rng(seed)
    xs, ys, ts = [], [], []
    cx, cy = 50, 50
    bx, by = 200.0, 30.0
    apex, blob = [], []
    for s in range(num_slices):
        x1 = rng.integers(max(0, cx - 40), cx + 1, n // 2).astype(np.int32)
        y1 = rng.integers(max(0, cy - 40), cy + 1, n // 2).astype(np.int32)
        x2 = np.clip(rng.normal(bx, 3.0, n // 2), 0, 255).astype(np.int32)
        y2 = np.clip(rng.normal(by, 3.0, n // 2), 0, 127).astype(np.int32)
        xs.append(np.concatenate([x1, x2]))
        ys.append(np.concatenate([y1, y2]))
        ts.append((1000 * (s + 1) + np.sort(rng.integers(0, 900, n))).astype(np.int64))
        apex.append((cx, cy))
        blob.append((bx, by))
        cx += 6
        by += 3.0
    return ((np.concatenate(xs), np.concatenate(ys), np.concatenate(ts),
             np.zeros(num_slices * n, np.int32)), apex, blob)


def adversarial_scene(n=2048, num_slices=12, probe_slice=8, probe=(58, 64)):
    """tests/test_temporal.py's warm-up adversarial scene: a static square
    repainted every slice, a 2-px stroke painted in slices 0-1 only, and one
    probe event in slice 8 whose eFAST arcs read the stale stroke."""
    sq = np.stack([a.ravel() for a in np.meshgrid(np.arange(180, 220), np.arange(40, 80))], 1)
    stroke = np.stack(np.meshgrid(np.arange(50, 71), np.arange(60, 62)), -1).reshape(-1, 2)
    xs, ys, ts = [], [], []
    for s in range(num_slices):
        ev = [sq]
        if s in (0, 1):
            ev.append(stroke)
        if s == probe_slice:
            ev.append(np.array([probe]))
        ev = np.concatenate(ev)
        ev = np.concatenate([sq[:n - len(ev)], ev])   # pad first: probe and stroke last
        xs.append(ev[:, 0])
        ys.append(ev[:, 1])
        ts.append(10000 * (s + 1) + np.arange(n))
    return (np.concatenate(xs).astype(np.int32), np.concatenate(ys).astype(np.int32),
            np.concatenate(ts).astype(np.int64), np.zeros(num_slices * n, np.int32))


def exact_cfg(config, exact_pallas=True):
    """tests/test_temporal.py's exact-engine configuration."""
    return config.EngineConfig(
        sensor=config.SensorConfig(width=256, height=128),
        slicing=config.SliceConfig(n_events=512),
        dedup=config.DedupConfig(exact=True),
        cluster=config.ClusterConfig(sz_buffer=256, radius=15.0, min_n=3, max_clusters=32,
                                     max_members=512, exact_pallas=exact_pallas))


def blob_scene(num_slices=16, n=512, seed=0):
    """Three blobs moving apart (tests/test_temporal.py's exact scene):
    (x, y, t, p) and the blob centres per slice."""
    rng = np.random.default_rng(seed)
    centers = np.array([[60., 60.], [180., 40.], [120., 100.]])
    vel = np.array([[2., 1.], [-2., 1.5], [1., -1.5]])
    xs, ys, ts, paths = [], [], [], []
    for _ in range(num_slices):
        c = rng.integers(0, 3, n)
        xs.append(np.clip(rng.normal(centers[c, 0], 3.0), 0, 255).astype(np.int32))
        ys.append(np.clip(rng.normal(centers[c, 1], 3.0), 0, 127).astype(np.int32))
        ts.append((1000 * (len(ts) + 1) + np.sort(rng.integers(0, 900, n))).astype(np.int64))
        paths.append(centers.copy())
        centers += vel
    return ((np.concatenate(xs), np.concatenate(ys), np.concatenate(ts),
             np.zeros(num_slices * n, np.int32)), paths)


N_TILES, TILE_W = 4, 64


def tile_cfg(config):
    """tests/test_parallel.py's distributed-cluster configuration."""
    return config.EngineConfig(
        sensor=config.SensorConfig(width=TILE_W * N_TILES, height=128),
        cluster=config.ClusterConfig(max_clusters=16, radius=15.0, min_n=3),
        dedup=config.DedupConfig(exact=True))


def tile_cluster_inputs(n_slices=4, cap=256):
    """Per slice, (N_TILES, cap) x, y, valid: one blob per tile, moving
    (tests/test_parallel.py's equivalence case)."""
    rng = np.random.default_rng(1)
    out = []
    for s in range(n_slices):
        x = np.zeros((N_TILES, cap), np.int32)
        y = np.zeros((N_TILES, cap), np.int32)
        for k in range(N_TILES):
            cx = k * TILE_W + TILE_W // 2 + 3 * s
            x[k] = np.clip(rng.normal(cx, 4, cap), k * TILE_W, (k + 1) * TILE_W - 1)
            y[k] = np.clip(rng.normal(64 + 2 * s, 4, cap), 0, 127)
        out.append((x, y, np.ones((N_TILES, cap), bool)))
    return out


def tile_hash_inputs(cap=128):
    """tests/test_parallel.py's first tiled case: one blob per tile, one
    slice, the default (hash) dedup: (N_TILES, cap) x, y, valid."""
    rng = np.random.default_rng(0)
    x = np.zeros((N_TILES, cap), np.int32)
    y = np.zeros((N_TILES, cap), np.int32)
    for k in range(N_TILES):
        x[k] = np.clip(rng.normal(k * TILE_W + TILE_W // 2, 4, cap), k * TILE_W,
                       (k + 1) * TILE_W - 1)
        y[k] = np.clip(rng.normal(64, 4, cap), 0, 127)
    return x, y, np.ones((N_TILES, cap), bool)


def tile_hash_cfg(config):
    return dataclasses.replace(tile_cfg(config), dedup=config.DedupConfig())


NMS_CAP = 32


def nms_chain_cfg(config, rounds):
    """tests/test_parallel.py's adversarial NMS chain at `rounds` exchange
    rounds."""
    base = config.EngineConfig(sensor=config.SensorConfig(width=TILE_W * N_TILES, height=128),
                               nms=config.NMSConfig(box_size=15, max_corners=NMS_CAP))
    return dataclasses.replace(base, parallel=dataclasses.replace(
        base.parallel, nms_exchange_rounds=rounds))


def nms_chain_inputs():
    """A trigger corner at x = 50 (tile 0's right strip), then a chain 14 px
    apart across tiles 1-3, all at y = 60: (N_TILES, NMS_CAP) x, y, valid
    in tile-major order."""
    chain = [50] + list(range(64, TILE_W * N_TILES - 8, 14))
    px = np.zeros((N_TILES, NMS_CAP), np.int32)
    py = np.zeros((N_TILES, NMS_CAP), np.int32)
    pv = np.zeros((N_TILES, NMS_CAP), bool)
    fill = [0] * N_TILES
    for cx in chain:
        k = min(cx // TILE_W, N_TILES - 1)
        px[k, fill[k]], py[k, fill[k]], pv[k, fill[k]] = cx, 60, True
        fill[k] += 1
    return px, py, pv


CORNER_SLICES = 6


def corner_tile_inputs():
    """The scene's first CORNER_SLICES slices bucketed into N_TILES tiles:
    (S, N_TILES, cap) x, y, t (rebased) and valid."""
    from evflow_tpu_torch import config, io
    from evflow_tpu_torch.parallel.tiling import bucket_slices_by_tile
    cfg = scene_cfg(config)
    s = io.slice_by_count(io.EventStream(*scene(CORNER_SLICES)[0]), cfg.slicing.n_events)
    t = s.t - int(s.t[0, 0])
    x, y, t, _p, cnt = bucket_slices_by_tile(s.x, s.y, t, s.p, s.valid_mask(), N_TILES,
                                             cfg.sensor.width, s.slice_capacity)
    valid = np.arange(s.slice_capacity)[None, None, :] < cnt[..., None]
    return x, y, t.astype(np.int32), valid


# --------------------------------------------------------------------------
# ranks
# --------------------------------------------------------------------------

def run_ranks(target, size: int, tmp_path) -> list:
    """target(rank, size, store, out) on `size` spawned ranks; each rank's
    saved arrays. A rank that has not ended within RANK_TIMEOUT_S fails the
    test."""
    ctx = mp.get_context("spawn")
    store, out = str(tmp_path / "store"), str(tmp_path / "out")
    procs = [ctx.Process(target=target, args=(r, size, store, out)) for r in range(size)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(RANK_TIMEOUT_S)
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        assert not hung, f"ranks {hung} did not end within {RANK_TIMEOUT_S} s"
        assert [p.exitcode for p in procs] == [0] * size
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
    return [dict(np.load(f"{out}.{r}.npz")) for r in range(size)]


def _gloo(rank, size, store):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, size), rank=rank,
                            world_size=size)


def _named(prefix, tree) -> dict:
    from evflow_tpu_torch import interop
    return {prefix + name: leaf for name, leaf in interop.named_leaves(tree)}


def tiling_rank(rank, size, store, out):
    """On a tile mesh of N_TILES ranks: the NMS chain at 2 and N_TILES
    rounds, the tiled cluster step over tile_cluster_inputs and (hash
    dedup) tile_hash_inputs, the tiled corner step over
    corner_tile_inputs."""
    import torch.distributed as dist
    from evflow_tpu_torch import config, io
    from evflow_tpu_torch.models import fastcluster
    from evflow_tpu_torch.parallel import mesh, tiling
    _gloo(rank, size, store)
    try:
        res = {}
        m = mesh.make_tile_mesh(size)
        ax = m.axis("tile")
        px, py, pv = nms_chain_inputs()
        for rounds in (2, N_TILES):
            filt = tiling.tile_local_nms(torch.as_tensor(px[rank]), torch.as_tensor(py[rank]),
                                         torch.as_tensor(pv[rank]), ax, ax.index, ax.size,
                                         ax.index * TILE_W, TILE_W,
                                         nms_chain_cfg(config, rounds))
            res.update(_named(f"nms{rounds}", (filt.x, filt.count)))

        cfg = tile_cfg(config)
        step = tiling.make_tiled_cluster_flow_step(m, cfg)
        st = fastcluster.init_state(cfg.cluster, device="cpu")
        for s, (x, y, v) in enumerate(tile_cluster_inputs()):
            st, o, uc, rc = step(st, *(torch.as_tensor(a[rank]) for a in (x, y, v)))
            res.update(_named(f"cl{s}", (st, o, uc, rc)))

        hcfg = tile_hash_cfg(config)
        res.update(_named("hash", tiling.make_tiled_cluster_flow_step(m, hcfg)(
            fastcluster.init_state(hcfg.cluster, device="cpu"),
            *(torch.as_tensor(a[rank]) for a in tile_hash_inputs()))))

        scfg = scene_cfg(config)
        cstep = tiling.make_tiled_corner_step(m, N_TILES, scfg)
        slab, tracks, idx = tiling.init_tiled_corner_state(m, N_TILES, scfg, device="cpu")
        for s, ev in enumerate(zip(*corner_tile_inputs())):
            slab, tracks, idx, o = cstep(slab, tracks, idx,
                                         *(torch.as_tensor(a[rank]) for a in ev))
            res.update(_named(f"co{s}", o))
        res.update(_named("co_final", (slab, tracks, idx)))
        np.savez(f"{out}.{rank}.npz", **res)
    finally:
        dist.destroy_process_group()


TEMPORAL_GRID = (2, 2, 4)           # windows, tiles, warm-up
ADVERSARIAL_WARMUPS = (2, 6)
EXACT_WINDOWS, EXACT_WARMUP = 4, 3


def temporal_rank(rank, size, store, out):
    """On 4 ranks: run_temporal on the (2 x 2) grid over the scene, over the
    adversarial scene at both warm-ups, and run_temporal_exact on 4 windows
    over the blob scene."""
    import torch.distributed as dist
    from evflow_tpu_torch import config, io
    from evflow_tpu_torch.parallel import mesh, temporal
    _gloo(rank, size, store)
    try:
        res = {}
        cfg = scene_cfg(config)
        n_windows, n_tiles, warmup = TEMPORAL_GRID
        grid = mesh.make_grid_mesh(n_windows, n_tiles, cfg.parallel)
        slices = io.slice_by_count(io.EventStream(*scene()[0]), cfg.slicing.n_events)
        res.update(_named("grid", temporal.run_temporal(
            slices, grid, n_windows, n_tiles, warmup, cfg, device="cpu")))
        adv = io.slice_by_count(io.EventStream(*adversarial_scene()), cfg.slicing.n_events)
        for w in ADVERSARIAL_WARMUPS:
            o = temporal.run_temporal(adv, grid, n_windows, n_tiles, w, cfg, device="cpu")
            res[f"adv{w}"] = o.num_corners.numpy()
        ecfg = exact_cfg(config)
        data = mesh.make_data_mesh(EXACT_WINDOWS, ecfg.parallel)
        bs = io.slice_by_count(io.EventStream(*blob_scene()[0]), ecfg.slicing.n_events)
        res.update(_named("exact", temporal.run_temporal_exact(
            bs, data, EXACT_WINDOWS, EXACT_WARMUP, ecfg, device="cpu")))
        np.savez(f"{out}.{rank}.npz", **res)
    finally:
        dist.destroy_process_group()


# --------------------------------------------------------------------------
# the mesh itself
# --------------------------------------------------------------------------

def test_mesh_without_a_group_is_one_rank_and_runs_no_collective():
    from evflow_tpu_torch.parallel import mesh
    m = mesh.make_grid_mesh(1, 1)
    assert [(a.name, a.size) for a in m.axes] == [("data", 1), ("tile", 1)]
    ax = m.axis("tile")
    assert (ax.size, ax.index, ax.group) == (1, 0, None)
    x = torch.arange(6, dtype=torch.int32).reshape(2, 3)
    assert mesh.psum(x, ax) is x
    assert torch.equal(mesh.all_gather(x, ax), x[None])
    assert torch.equal(mesh.ppermute(x, ax, 1), x)
    with pytest.raises(ValueError, match="needs 4 ranks"):
        mesh.make_grid_mesh(2, 2)
    with pytest.raises(KeyError):
        m.axis("nope")
    mesh.initialize_distributed(num_processes=1)      # a no-op
    assert not mesh.grouped()


def test_mesh_in_a_group_of_one_runs_its_collectives():
    import torch.distributed as dist
    from evflow_tpu_torch.parallel import mesh
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        calls = []
        saved = dist.all_reduce, dist.all_gather

        def counted(name, fn):
            def call(*a, **k):
                calls.append(name)
                return fn(*a, **k)
            return call

        dist.all_reduce, dist.all_gather = counted("all_reduce", saved[0]), \
            counted("all_gather", saved[1])
        try:
            m = mesh.make_grid_mesh(1, 1)
            ax = m.axis("data")
            assert ax.group is not None and ax.staged and ax.size == 1
            x = torch.tensor([True, False])
            s = torch.tensor(7, dtype=torch.int32)
            assert torch.equal(mesh.psum(s, ax), s) and mesh.psum(s, ax) is not s
            assert torch.equal(mesh.all_gather(x, ax), x[None])
            assert torch.equal(mesh.ppermute(x, ax, -1), x)
        finally:
            dist.all_reduce, dist.all_gather = saved
        assert calls == ["all_reduce", "all_reduce", "all_gather", "all_gather"], calls
    finally:
        dist.destroy_process_group()
