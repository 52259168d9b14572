"""The port's temporal layer (evflow_tpu_torch/parallel/temporal.py and the
CLI's `temporal`) against the JAX package, on the CPU: the port on 4 Gloo
ranks (test_torch_ranks.py), JAX on meshes of conftest's 8 CPU devices,
the same numpy inputs (tests/test_temporal.py's scenes).

Tolerances: window prep, ids, masks, counts and every integer or bool
field bit-equal; cluster floats within rtol 1e-5, atol 1e-3 and track
floats within rtol 1e-5, atol 1e-4 (f32 sums in another order, as in
test_torch_tiling.py); the refined boundary positions within rtol 1e-4,
atol 1e-3 where a boundary is supported (boundary_ok), since the two
packages' LU solves of the regularized systems round differently; the
exact engine over windows bit-equal in every leaf.

A chain with fewer observations than its system has unknowns (2 per
window it covers, plus 1) has a solve that only the 1e-6 regularization
decides: its boundary positions follow the rounding of its blocks, so a
few 1e-6 px differences in the tracker's positions move them by tenths of
a pixel, even where boundary_ok holds (JAX's boundary_ok tests support,
not rank). The grid run's boundary positions are held where boundary_ok
holds and the chain's system is determined; the chains left out are
counted.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from evflow_tpu import config as jconfig, io as jio
from evflow_tpu.models import tracker as jtracker
from evflow_tpu.parallel import temporal as jtemporal
from evflow_tpu.run import main as jax_main
from evflow_tpu_torch import config, interop, io
from evflow_tpu_torch.models import aeclustering as ae, pipeline, tracker
from evflow_tpu_torch.parallel import mesh, temporal
from evflow_tpu_torch.run import main

import test_torch_ranks as R

ROOT = Path(__file__).resolve().parent.parent
CLUSTER_TOL = dict(rtol=1e-5, atol=1e-3)
TRACK_TOL = dict(rtol=1e-5, atol=1e-4)
BOUNDARY_TOL = dict(rtol=1e-4, atol=1e-3)


def jax_grid(n_data, n_tiles):
    return Mesh(np.array(jax.devices()[:n_data * n_tiles]).reshape(n_data, n_tiles),
                ("data", "tile"))


def slices_of(pkg_io, arrays, n):
    return pkg_io.slice_by_count(pkg_io.EventStream(*arrays), n)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return R.run_ranks(R.temporal_rank, 4, tmp_path_factory.mktemp("temporal"))


def determined(out):
    """(K, W+1) boundaries held to JAX's: supported, on a chain whose
    observations determine its system (see the module doc)."""
    r = out.refined
    n_obs, n_win = np.asarray(r.n_obs), np.asarray(r.n_windows)
    return np.asarray(r.boundary_ok) & (n_obs >= 2 * n_win + 1)[:, None]


def assert_temporal_close(got: dict, prefix: str, want):
    """A saved TemporalOutput against JAX's: discrete leaves equal,
    cluster and track floats within their tolerances, boundary positions
    where supported."""
    for name, w in interop.named_leaves(want, prefix):
        a = got[name]
        assert a.dtype == w.dtype and a.shape == w.shape, (name, a.dtype, a.shape, w.dtype,
                                                           w.shape)
        if name.endswith("boundary_pos"):
            np.testing.assert_allclose(a[determined(want)], w[determined(want)],
                                       **BOUNDARY_TOL, err_msg=name)
        elif a.dtype.kind == "f":
            tol = TRACK_TOL if ".track_" in name else CLUSTER_TOL
            np.testing.assert_allclose(a, w, **tol, err_msg=name)
        else:
            np.testing.assert_array_equal(a, w, err_msg=name)


# ------------------------------------------------------------ window prep

@pytest.mark.parametrize("window_range", [None, range(2, 5)])
def test_window_prep_equals_the_jax_package(window_range):
    rng = np.random.default_rng(5)
    n, s_total = 512, 40
    arrays = (rng.integers(0, 256, n * s_total).astype(np.int32),
              rng.integers(0, 128, n * s_total).astype(np.int32),
              np.sort(rng.integers(0, 10**6, n * s_total)).astype(np.int64) + 1000,
              np.zeros(n * s_total, np.int32))
    sl, jsl = slices_of(io, arrays, n), slices_of(jio, arrays, n)
    cfg, jcfg = (c.EngineConfig(sensor=c.SensorConfig(width=256, height=128))
                 for c in (config, jconfig))
    ours = temporal.window_tile_events(sl, 5, 4, 3, cfg, capacity=300,
                                       window_range=window_range)
    theirs = jtemporal.window_tile_events(jsl, 5, 4, 3, jcfg, capacity=300,
                                          window_range=window_range)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
    for cap in (None, 200):
        ours = temporal.window_events(sl, 5, 3, cap, window_range=window_range)
        theirs = jtemporal.window_events(jsl, 5, 3, cap, window_range=window_range)
        for a, b in zip(ours, theirs):
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------- fusion

def _random_tracks(rng, t):
    return dict(active=rng.random(t) < 0.7, frames_since=rng.integers(0, 2, t).astype(np.int32),
                label=rng.integers(0, 6, t).astype(np.int32),
                pos=rng.uniform(0, 200, (t, 2)).astype(np.float32),
                velocity=rng.normal(0, 3, (t, 2)).astype(np.float32))


def test_blocks_update_equals_the_jax_package():
    """_blocks_update over 6 slices of random tracker states, from
    init_blocks, bit-equal."""
    rng = np.random.default_rng(3)
    t, n_emit = 16, 5
    jcfg = jconfig.TrackerConfig(max_tracks=t)
    jtr0, tr0 = jtracker.init_state(jcfg), tracker.init_state(
        config.TrackerConfig(max_tracks=t), device="cpu")
    blocks, jblocks = temporal.init_blocks(t, device="cpu"), jtemporal.init_blocks(t)
    emit = np.array([False, True, True, True, True, True])
    us = temporal._window_u(emit, n_emit, "cpu")
    for s in range(len(emit)):
        f = _random_tracks(rng, t)
        jtr = jtr0._replace(**{k: jnp.asarray(v) for k, v in f.items()})
        tr = tr0._replace(**{k: torch.as_tensor(v) for k, v in f.items()})
        u = jnp.float32(np.cumsum(emit)[s]) / n_emit
        assert float(us[s]) == float(u)
        blocks = temporal._blocks_update(blocks, tr, us[s], bool(emit[s]))
        jblocks = jtemporal._blocks_update(jblocks, jtr, u, jnp.asarray(emit[s]))
        interop.assert_trees_close(blocks, jblocks, 0, 0, what=f"slice {s}")


def _curved_blocks(w=3, t=8, s=10, slots=(2, 5), seed=0):
    """Normal-equation blocks of quadratic trajectories observed over w
    windows of s slices (0.5 px noise), one per slot in `slots`, as
    tests/test_temporal.py builds them; returns the numpy fields and the
    trajectories."""
    rng = np.random.default_rng(seed)

    def traj(k, tg):
        u = tg / (w * s)
        return np.array([100.0 + 60.0 * u + 25.0 * u * u + 200 * k,
                         50.0 - 30.0 * u + 10.0 * u * u + 40 * k])

    d = {"label": np.full((w, t), -1, np.int32), "nobs": np.zeros((w, t), np.int32),
         "u_first": np.zeros((w, t), np.float32), "u_last": np.zeros((w, t), np.float32),
         "pos_first": np.zeros((w, t, 2), np.float32), "pos_last": np.zeros((w, t, 2), np.float32),
         "vel_first": np.zeros((w, t, 2), np.float32), "vel_last": np.zeros((w, t, 2), np.float32),
         "H": np.zeros((w, t, 3, 3), np.float32), "g": np.zeros((w, t, 3, 2), np.float32)}
    for k, slot in enumerate(slots):
        for wi in range(w):
            d["label"][wi, slot] = 7 + k
            for si in range(s):
                u = (si + 1) / s
                tg = wi * s + si + 1
                pos = traj(k, tg) + rng.normal(0, 0.5, 2)
                vel = traj(k, tg) - traj(k, tg - 1)
                phi = np.array([1 - u, u, 4 * u * (1 - u)], np.float32)
                d["H"][wi, slot] += np.outer(phi, phi)
                d["g"][wi, slot] += phi[:, None] * pos[None, :]
                if d["nobs"][wi, slot] == 0:
                    d["u_first"][wi, slot], d["pos_first"][wi, slot] = u, pos
                    d["vel_first"][wi, slot] = vel
                d["nobs"][wi, slot] += 1
                d["u_last"][wi, slot], d["pos_last"][wi, slot] = u, pos
                d["vel_last"][wi, slot] = vel
    return d, traj


def _port_blocks(jblocks, w, t):
    """JAX-made blocks carried into the port by interop."""
    template = temporal.TrackletBlocks(*(torch.stack([f] * w)
                                         for f in temporal.init_blocks(t, device="cpu")))
    return interop.from_jax(template, jblocks)


def test_schur_fusion_recovers_curved_trajectory():
    """tests/test_temporal.py's pure-math case in the port: one quadratic
    trajectory across 3 windows chains into one track whose refined
    boundary positions match the truth, curvature included."""
    w, t, s = 3, 8, 10
    d, traj = _curved_blocks(w, t, s, slots=(2,))
    blocks = temporal.TrackletBlocks(**{k: torch.as_tensor(v) for k, v in d.items()})
    cfg = config.EngineConfig(tracker=config.TrackerConfig(max_tracks=t))
    r = temporal.fuse_tracklets(blocks, s, cfg)
    valid = np.where(r.valid.numpy())[0]
    assert len(valid) == 1 and int(r.n_windows[valid[0]]) == w
    k = valid[0]
    assert bool(r.boundary_ok[k].all()) and int(r.n_obs[k]) == w * s
    for j in range(w + 1):
        err = np.linalg.norm(r.boundary_pos[k, j].numpy() - traj(0, j * s))
        assert err < 1.5, (j, err)


@pytest.mark.parametrize("case", ["curved", "random"])
def test_fusion_equals_the_jax_package(case):
    """fuse_tracklets and fuse_clusters on JAX-made blocks carried by
    interop: two curved tracks over 3 windows, and random blocks (broken
    chains, missing windows, unsupported boundaries)."""
    w, t, s = 3, 8, 10
    if case == "curved":
        d, _ = _curved_blocks(w, t, s, slots=(2, 5))
    else:
        rng = np.random.default_rng(11)
        d, _ = _curved_blocks(w, t, s, slots=(1, 4, 6))
        gone = rng.random((w, t)) < 0.3
        d["nobs"][gone] = 0
        d["u_first"] = np.where(d["nobs"] > 0, rng.uniform(0, 0.4, (w, t)), 0).astype(np.float32)
        d["u_last"] = np.where(d["nobs"] > 0, rng.uniform(0.6, 1, (w, t)), 0).astype(np.float32)
    jblocks = jtemporal.TrackletBlocks(**{k: jnp.asarray(v) for k, v in d.items()})
    blocks = _port_blocks(jblocks, w, t)
    interop.assert_trees_close(blocks, jblocks, 0, 0)
    jcfg = jconfig.EngineConfig(tracker=jconfig.TrackerConfig(max_tracks=t))
    cfg = config.EngineConfig(tracker=config.TrackerConfig(max_tracks=t))
    want = jax.device_get(jtemporal.fuse_tracklets(jblocks, s, jcfg))
    got = temporal.fuse_tracklets(blocks, s, cfg)
    assert int(np.asarray(want.valid).sum()) > 0
    ok = np.asarray(want.boundary_ok)
    for (name, a), (_, b) in zip(interop.named_leaves(got), interop.named_leaves(want)):
        if name == ".boundary_pos":
            np.testing.assert_allclose(a[ok], b[ok], **BOUNDARY_TOL)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)
    # clusters: the blocks' boundary positions as centroid tables
    first_ok, final_ok = d["nobs"] > 0, np.roll(d["nobs"] > 0, 1, axis=1)
    args = (d["pos_first"], first_ok, d["pos_last"], final_ok)
    got = temporal.fuse_clusters(*(torch.as_tensor(a) for a in args),
                                 config.EngineConfig(cluster=config.ClusterConfig(radius=60.0)))
    want = jtemporal.fuse_clusters(*(jnp.asarray(a) for a in args),
                                   jconfig.EngineConfig(cluster=jconfig.ClusterConfig(radius=60.0)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() >= 0).sum() > 0


# ------------------------------------------------- the temporal pipelines

@pytest.fixture(scope="module")
def jax_grid_run():
    n_windows, n_tiles, warmup = R.TEMPORAL_GRID
    slices = slices_of(jio, R.scene()[0], 2048)
    return jax.device_get(jtemporal.run_temporal(
        slices, jax_grid(n_windows, n_tiles), n_windows, n_tiles, warmup,
        R.scene_cfg(jconfig)))


def test_run_temporal_grid_equals_the_jax_package(ranks, jax_grid_run):
    """run_temporal on a (2 windows x 2 tiles) grid of Gloo ranks against
    JAX's on a (2 x 2) device mesh: every per-slice stream and the fusion
    products."""
    out = jax_grid_run
    assert int(np.asarray(out.refined.valid).sum()) > 0
    # the supported boundaries left out: 5 on 4 chains of 2-4 observations
    left_out = np.asarray(out.refined.boundary_ok) & ~determined(out)
    assert left_out.sum() == 5, np.argwhere(left_out)
    assert determined(out).sum() == 5, np.argwhere(determined(out))
    assert int(np.asarray(out.num_corners).sum()) > 0
    assert (np.asarray(out.cluster_chain) >= 0).any()
    for got in ranks:
        assert_temporal_close(got, "grid", out)


def test_run_temporal_output_is_replicated_on_every_rank(ranks):
    for got in ranks[1:]:
        assert sorted(got) == sorted(ranks[0])
        for name, a in got.items():
            np.testing.assert_array_equal(a, ranks[0][name], err_msg=name)


def test_run_temporal_grid_tracks_the_scene(ranks):
    """tests/test_temporal.py's scene checks on the port's grid run: a chain
    spans both windows with its refined boundary displacement recovering
    the wedge's motion, and the blob's cluster chains across the boundary."""
    got = ranks[0]
    n_emit = got["grid.cl_reported"].shape[1]
    r = {f: got[f"grid.refined.{f}"] for f in temporal.RefinedTracks._fields}
    span = r["valid"] & (r["n_windows"] == 2) & r["boundary_ok"][:, 1] & r["boundary_ok"][:, 2]
    assert span.any()
    disp = r["boundary_pos"][:, 2] - r["boundary_pos"][:, 1]
    assert (span & (np.linalg.norm(disp - [6.0 * n_emit, 0.0], axis=1) < 12.0)).any()
    _, _, blob = R.scene()
    cent0, rep0 = got["grid.cl_centroid"][0, -1], got["grid.cl_reported"][0, -1]
    d0 = np.linalg.norm(cent0 - np.asarray(blob[n_emit - 1]), axis=1)
    d0[~rep0] = 1e9
    chain = got["grid.cluster_chain"]
    cid = chain[0, int(np.argmin(d0))]
    assert cid >= 0 and (chain[1] == cid).any()


def test_warmup_adversarial(ranks):
    """tests/test_temporal.py's warm-up adversarial case in the port: on the
    (2 x 2) grid at warm-up 2 the windowed run misses exactly the
    engineered stale-evidence corner and never detects more than the
    sequential run; at warm-up 6 the two agree."""
    cfg = R.scene_cfg(config)
    sl = slices_of(io, R.adversarial_scene(), 2048)
    st = pipeline.init_corner_state(cfg, device="cpu")
    seq = []
    ts = (sl.t - sl.t[0, 0]).astype(np.int32)
    for s in range(sl.num_slices):
        st, o = pipeline.corner_track_step(
            st, *(torch.as_tensor(a[s]) for a in (sl.x, sl.y, ts, sl.valid_mask())), cfg)
        seq.append(int(o.num_corners))
    seq = np.asarray(seq)
    win2 = ranks[0]["adv2"].reshape(-1)
    assert seq[8] >= 1, seq
    assert (win2 <= seq).all(), (win2, seq)
    expect = np.zeros_like(seq)
    expect[8] = 1
    np.testing.assert_array_equal(seq - win2, expect)
    np.testing.assert_array_equal(ranks[0]["adv6"].reshape(-1), seq)


def test_run_temporal_exact_equals_the_jax_package(ranks):
    """run_temporal_exact on 4 windows of Gloo ranks against JAX's on a
    4-device data mesh with exact_pallas=False (JAX's Pallas engine differs
    from its own update_slice at a full ring, see test_torch_exact.py):
    every leaf bit-equal."""
    slices = slices_of(jio, R.blob_scene()[0], 512)
    want = jax.device_get(jtemporal.run_temporal_exact(
        slices, Mesh(np.array(jax.devices()[:R.EXACT_WINDOWS]), ("data",)), R.EXACT_WINDOWS,
        warmup=R.EXACT_WARMUP, cfg=R.exact_cfg(jconfig, exact_pallas=False)))
    assert int(np.asarray(want.alive).sum()) > 0
    for got in ranks:
        for name, w in interop.named_leaves(want, "exact"):
            np.testing.assert_array_equal(got[name], w, err_msg=name)


def test_run_temporal_exact_equals_the_sequential_run(ranks):
    """tests/test_temporal.py's property on the port: every emitted slice's
    live clusters equal the sequential exact run's, counts, means,
    centroids and member digests, up to slot and cid relabeling; each blob
    keeps one chain id across the windows."""
    cfg = R.exact_cfg(config)
    arrays, paths = R.blob_scene()
    sl = slices_of(io, arrays, 512)
    st = ae.init_state(cfg.cluster, device="cpu")._replace(has_t0=torch.tensor(True))
    cum = torch.zeros((), dtype=torch.int32)
    ts = (sl.t - sl.t[0, 0]).astype(np.int32)
    seq = []
    for s in range(sl.num_slices):
        st, view, cum = pipeline.cluster_flow_step_exact(
            st, *(torch.as_tensor(a[s]) for a in (sl.x, sl.y, ts, sl.valid_mask())), cfg, cum)
        seq.append([a.numpy() for a in (view.alive, view.n, view.mu, view.centroid,
                                        ae.membership_digest(st, cfg.cluster))])
    got = ranks[0]
    alive, n, mu, cen, dig, chain = (got[f"exact.{f}"] for f in (
        "alive", "n", "mu", "centroid", "digest", "cluster_chain"))
    n_emit = alive.shape[1]

    def canon(a, nn, m, c, dg):
        return sorted((int(nn[i]), float(c[i, 0]), float(c[i, 1]), float(m[i, 0]),
                       float(m[i, 1]), int(dg[i])) for i in np.where(a)[0])

    for w in range(R.EXACT_WINDOWS):
        for s in range(n_emit):
            g = w * n_emit + s
            assert canon(alive[w, s], n[w, s], mu[w, s], cen[w, s], dig[w, s]) \
                == canon(*seq[g]), (w, s)
    for b in range(3):
        ids = set()
        for w in range(R.EXACT_WINDOWS):
            live = np.where(alive[w, -1])[0]
            d = np.abs(cen[w, -1, live] - paths[(w + 1) * n_emit - 1][b][None, :]).sum(1)
            assert d.min() < 6.0
            ids.add(int(chain[w, live[np.argmin(d)]]))
        assert len(ids) == 1, (b, ids)


# ------------------------------------------------------------------- CLI

@pytest.fixture(scope="module")
def scene_csv(tmp_path_factory):
    """tests/test_temporal.py's CLI input: 8 scene slices, one DEFAULT slice."""
    p = str(tmp_path_factory.mktemp("temporal") / "scene.csv")
    io.save_csv(io.EventStream(*R.scene(num_slices=8)[0]), p)
    return p


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _torchrun(argv, size):
    """The port's CLI on `size` ranks as torchrun starts them (Gloo on the
    CPU); every rank's (stdout, stderr)."""
    env = dict(os.environ, WORLD_SIZE=str(size), MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()), PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-m", "evflow_tpu_torch.run", "--device", "cpu",
                               *argv], env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(size)]
    try:
        outs = [p.communicate(timeout=R.RANK_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0] * size, [o[1][-2000:] for o in outs]
    return outs


@pytest.mark.parametrize("argv,size", [
    (["temporal", "--windows", "2", "--tiles", "2", "--warmup", "2"], 4),
    (["temporal", "--windows", "2", "--warmup", "2", "--exact"], 2),
])
def test_cli_temporal_prints_the_jax_cli_lines(argv, size, scene_csv, capsys):
    """`temporal` and `temporal --exact` under torchrun's environment print
    the JAX CLI's lines on rank 0 and nothing on the others."""
    argv = argv + ["--input", scene_csv]
    jax_main(argv)
    want = capsys.readouterr().out
    outs = _torchrun(argv, size)
    assert outs[0][0] == want
    assert all(o[0] == "" for o in outs[1:])
    assert "window 1 slice" in want
    assert ("cross-window cluster chains:" if "--exact" in argv
            else "refined track chains:") in want


def test_cli_temporal_one_rank_runs_a_grid_of_one(scene_csv, capsys):
    for extra in ([], ["--exact"]):
        argv = ["temporal", "--input", scene_csv, "--windows", "1", "--tiles", "1",
                "--warmup", "0"] + extra
        jax_main(argv)
        want = capsys.readouterr().out
        main(argv + ["--device", "cpu"])
        assert capsys.readouterr().out == want


def test_interop_carries_tracklet_blocks_both_ways():
    d, _ = _curved_blocks()
    jblocks = jtemporal.TrackletBlocks(**{k: jnp.asarray(v) for k, v in d.items()})
    blocks = _port_blocks(jblocks, 3, 8)
    back = jtemporal.TrackletBlocks(*(jnp.asarray(a) for a in interop.to_leaves(blocks)))
    interop.assert_trees_close(back, jblocks, 0, 0)
    one = interop.from_jax(temporal.init_blocks(8, device="cpu"), jtemporal.init_blocks(8))
    interop.assert_trees_close(one, jtemporal.init_blocks(8), 0, 0)


def test_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default call is valid here")
    sl = slices_of(io, R.blob_scene(num_slices=2)[0], 512)
    with pytest.raises((RuntimeError, AssertionError)):
        temporal.run_temporal_exact(sl, mesh.make_data_mesh(1), 1, 0, R.exact_cfg(config))
