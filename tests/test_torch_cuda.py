"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked `cuda` and skips without a CUDA device. The file
imports no JAX, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

(`--noconftest`: the suite's conftest configures JAX).
"""

import dataclasses

import numpy as np
import pytest
import torch

from evflow_tpu.config import (DEFAULT, ClusterConfig, EFastConfig, NMSConfig,
                               SensorConfig, SliceConfig, TrackerConfig)
from evflow_tpu.io import slice_by_count, synthetic
from evflow_tpu_torch import interop, kernels
from evflow_tpu_torch.models import aeclustering as ae, aeclustering_kernel as aek
from evflow_tpu_torch.models import fastcluster, pipeline
from evflow_tpu_torch.ops import cluster_kernels as ck, efast

from test_torch_streams import STREAMS, drifting_blobs

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _surface(rng, h, w):
    sae = np.zeros((h, w), np.int32)
    for ax, ay, t0 in ((40, 40, 100), (100, 80, 200), (700, 300, 300), (1000, 600, 400)):
        sae[ay - 10:ay + 1, ax - 10:ax + 1] = rng.integers(t0, t0 + 50, (11, 11))
    nz = rng.random((h, w)) < 0.08
    sae[nz] = rng.integers(1, 90, nz.sum())
    return torch.as_tensor(sae)


def test_efast_stencil_matches_plain(cuda):
    rng = np.random.default_rng(9)
    sensor = SensorConfig()
    st = _surface(rng, 720, 1280).to(cuda)
    before = kernels.LAUNCHES["efast_stencil"]
    for cfg in (EFastConfig(), EFastConfig(group_track_axis_order=False)):
        for act in (torch.ones((30, 10), dtype=torch.bool),
                    torch.as_tensor(rng.random((30, 10)) < 0.4)):
            act = act.to(cuda)
            got = efast.corner_mask_stencil(st, act, cfg, sensor)
            assert torch.equal(got, efast.corner_mask_stencil_plain(st, act, cfg, sensor))
    assert int(got.sum()) > 0
    assert kernels.LAUNCHES["efast_stencil"] == before + 4
    # ragged edges: the last band and the last column tile are partial
    cut = SensorConfig(width=1200, height=700)
    act = torch.ones((30, 10), dtype=torch.bool, device=cuda)
    sub = st[:700, :1200].contiguous()
    assert torch.equal(efast.corner_mask_stencil(sub, act, EFastConfig(), cut),
                       efast.corner_mask_stencil_plain(sub, act, EFastConfig(), cut))


@pytest.mark.parametrize("n", [16384, 1000, 1])
def test_cluster_kernels_match_plain(cuda, n):
    rng = np.random.default_rng(n)
    c = 128
    x = torch.as_tensor(rng.integers(0, 1280, n).astype(np.int32), device=cuda)
    y = torch.as_tensor(rng.integers(0, 720, n).astype(np.int32), device=cuda)
    mu = torch.as_tensor((rng.random((c, 2)) * 800).astype(np.float32), device=cuda)
    mu[5] = mu[3]                                    # tie: lowest index wins
    alive = torch.as_tensor(rng.random(c) > 0.4, device=cuda)
    lk, dk = ck.assign_manhattan(x, y, mu, alive, 40.0)
    lp, dp = ck.assign_manhattan_plain(x, y, mu, alive, 40.0)
    assert torch.equal(lk, lp) and torch.equal(dk, dp)

    labels = torch.as_tensor(rng.integers(-1, c, n).astype(np.int32), device=cuda)
    labels[torch.as_tensor(rng.random(n) < 0.3, device=cuda)] = 3
    xf, yf = x.to(torch.float32), y.to(torch.float32)
    sk = ck.cluster_stats(labels, xf, yf, 0.5, c)
    sp = ck.cluster_stats_plain(labels, xf, yf, 0.5, c)
    assert torch.equal(sk[:, :3], sp[:, :3])     # counts and integer sums exact
    torch.testing.assert_close(sk, sp, rtol=1e-5, atol=1e-3)


def test_full_scan_on_card_matches_cpu(cuda):
    n = 2048
    cfg = dataclasses.replace(
        DEFAULT, sensor=SensorConfig(width=256, height=120),
        slicing=SliceConfig(n_events=n),
        efast=dataclasses.replace(DEFAULT.efast, max_candidates=1024),
        nms=NMSConfig(max_corners=128), tracker=TrackerConfig(max_tracks=64),
        cluster=ClusterConfig(max_clusters=32))
    stream = synthetic.moving_blob_stream(
        num_slices=6, events_per_slice=n,
        blob_centers=((60.0, 50.0), (180.0, 70.0), (120.0, 30.0)),
        velocities=((4.0, 1.0), (-3.0, 2.0), (1.0, -1.0)), sigma=6.0,
        width=256, height=120)
    sl = slice_by_count(stream, n, drop_partial=True)
    arrays = (sl.x, sl.y, (sl.t - int(stream.t[0])).astype(np.int32), sl.valid_mask())

    def scan(device):
        cl = fastcluster.init_state(cfg.cluster, device=device)
        co = pipeline.init_corner_state(cfg, device=device)
        return pipeline.full_scan(cl, co, *[torch.as_tensor(a, device=device)
                                            for a in arrays], cfg)

    kernels.reset_launches()
    (gcl, gco), (gclo, gcoo) = scan(cuda)
    assert kernels.LAUNCHES == {"efast_stencil": 6, "assign_manhattan": 6,
                                "cluster_stats": 6, "aeclustering_exact": 0}, kernels.LAUNCHES
    (wcl, wco), (wclo, wcoo) = scan("cpu")
    interop.assert_trees_close((gcl, gclo), (wcl, wclo), rtol=1e-5, atol=1e-3)
    interop.assert_trees_close((gco, gcoo), (wco, wcoo), rtol=1e-5, atol=1e-4)
    assert int(gcoo.num_corners.sum()) > 0


@pytest.mark.parametrize("name", list(STREAMS))
def test_exact_kernel_matches_plain(cuda, name):
    """The update_slice_pallas counterpart on the card against the plain
    update_slice on the CPU, every slice, every AEState field bit-equal."""
    make, cfg = STREAMS[name]
    ks, ps = ae.init_state(cfg, device=cuda), ae.init_state(cfg)
    before = kernels.LAUNCHES["aeclustering_exact"]
    slices = 0
    for s, arrays in enumerate(make()):
        ks = aek.update_slice_kernel(ks, *[torch.as_tensor(a, device=cuda) for a in arrays], cfg)
        ps = ae.update_slice(ps, *[torch.as_tensor(a) for a in arrays], cfg)
        torch.cuda.synchronize()
        interop.assert_trees_close(ks, ps, rtol=0, atol=0, what=f"{name} slice {s}")
        slices += 1
    assert kernels.LAUNCHES["aeclustering_exact"] == before + slices


@pytest.mark.parametrize("alpha", [0.5, 0.8])
def test_exact_kernel_default_widths(cuda, alpha):
    """C = 128, M = 1024 (dynamic shared memory of 20 KB), and C = 256,
    M = 4096 (80 KB: above the 48 KB default), on the drifting blobs."""
    for c, m in ((128, 1024), (256, 4096)):
        cfg = ClusterConfig(sz_buffer=800, radius=20.0, min_n=3, alpha=alpha,
                            max_clusters=c, max_members=m)
        ks, ps = ae.init_state(cfg, device=cuda), ae.init_state(cfg)
        for arrays in drifting_blobs(seed=1, n_slices=4, n=1500):
            ks = aek.update_slice_kernel(ks, *[torch.as_tensor(a, device=cuda)
                                               for a in arrays], cfg)
            ps = ae.update_slice(ps, *[torch.as_tensor(a) for a in arrays], cfg)
        interop.assert_trees_close(ks, ps, rtol=0, atol=0, what=f"C={c} M={m}")


def test_exact_kernel_limits(cuda):
    x = torch.zeros(8, dtype=torch.int32, device=cuda)
    v = torch.ones(8, dtype=torch.bool, device=cuda)
    for cfg in (ClusterConfig(max_clusters=aek.MAX_CLUSTERS + 1),
                ClusterConfig(max_members=aek.MAX_MEMBERS + 1),
                ClusterConfig(kappa=2)):
        with pytest.raises(ValueError):
            aek.update_slice_kernel(ae.init_state(cfg, device=cuda), x, x, x, x, v, cfg)
