"""parallel/batch.py under Gloo: world sizes 1, 2 and 4 on the CPU, each
rank a process of its own joined by a FileStore, against the port's
one-rank run (torch.distributed not initialized) of the same functions and
the unsharded models. The inputs are tests/test_parallel.py's: a 3001-point
clustered cloud with noise (not a multiple of any world size) and app D's
k-means ramp.

Tolerances: the OPTICS table and DBSCAN labels bit-equal; k-means labels,
counts and iterations equal, centroids within rtol 1e-5, atol 1e-3 (the
sum of per-rank partials reorders the float sums; the JAX package's test
allows the same).
"""

import multiprocessing as mp

import numpy as np
import pytest
import torch

from evflow_tpu_torch.config import DBSCANConfig, KMeansConfig
from evflow_tpu_torch.io import synthetic
from evflow_tpu_torch.models import dbscan, kmeans, optics
from evflow_tpu_torch.parallel import batch

N = 3001
EPS, MIN_PTS, K = 25.0, 10, 64
DCFG = DBSCANConfig(eps=20.0, core_min_pts=10, min_cluster_size=30, max_cluster_size=100000)
RANK_TIMEOUT_S = 120


def cloud() -> np.ndarray:
    rng = np.random.default_rng(0)
    cents = rng.uniform(0, 900, (12, 2))
    return np.concatenate([
        cents[rng.integers(0, 12, N - 500)] + rng.normal(0, 8, (N - 500, 2)),
        rng.uniform(0, 1000, (500, 2))]).astype(np.float32)[:N]


def run_all(group=None) -> dict:
    """The three sharded functions on the test inputs, as numpy arrays."""
    pts = cloud()
    out = {}
    table = batch.compute_neighbors_sharded(pts, EPS, MIN_PTS, max_neighbors=K, group=group,
                                            device="cpu")
    out.update({f"table.{f}": v.numpy() for f, v in zip(table._fields, table)})
    res = batch.dbscan_sharded(pts, None, DCFG, group=group, device="cpu")
    out.update({f"dbscan.{f}": v.numpy() for f, v in zip(res._fields, res)})
    km = batch.kmeans_sharded(synthetic.kmeans_ramp_data(2048),
                              synthetic.kmeans_initial_centroids(), cfg=KMeansConfig(),
                              group=group, device="cpu")
    out.update({f"kmeans.{f}": v.numpy() for f, v in zip(km._fields, km)})
    return out


def _rank(rank: int, size: int, store: str, out: str) -> None:
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, size), rank=rank,
                            world_size=size)
    try:
        assert batch.world() == (size, rank)
        np.savez(f"{out}.{rank}.npz", **run_all())
    finally:
        dist.destroy_process_group()


def run_ranks(size: int, tmp_path) -> list:
    """run_all on `size` Gloo ranks; each rank's results. A rank that has
    not ended within RANK_TIMEOUT_S fails the test."""
    ctx = mp.get_context("spawn")
    store, out = str(tmp_path / "store"), str(tmp_path / "out")
    procs = [ctx.Process(target=_rank, args=(r, size, store, out)) for r in range(size)]
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


@pytest.fixture(scope="module")
def one_rank():
    return run_all()


def test_one_rank_equals_the_unsharded_models(one_rank):
    pts = cloud()
    table = optics.compute_neighbors(pts, EPS, MIN_PTS, max_neighbors=K, device="cpu")
    for f, v in zip(table._fields, table):
        np.testing.assert_array_equal(one_rank[f"table.{f}"], v.numpy(), err_msg=f)
    res = dbscan.dbscan(torch.as_tensor(pts), None, DCFG)
    for f, v in zip(res._fields, res):
        np.testing.assert_array_equal(one_rank[f"dbscan.{f}"], v.numpy(), err_msg=f)
    assert int(res.num_clusters) > 0
    km = kmeans.kmeans(torch.as_tensor(synthetic.kmeans_ramp_data(2048)),
                       torch.as_tensor(synthetic.kmeans_initial_centroids()))
    for f, v in zip(km._fields, km):
        np.testing.assert_array_equal(one_rank[f"kmeans.{f}"], v.numpy(), err_msg=f)


@pytest.mark.parametrize("size", [1, 2, 4])
def test_gloo_ranks_equal_the_one_rank_run(size, tmp_path, one_rank):
    for got in run_ranks(size, tmp_path):
        assert sorted(got) == sorted(one_rank)
        for name, want in one_rank.items():
            if name in ("kmeans.centroids", "kmeans.error_max"):
                np.testing.assert_allclose(got[name], want, rtol=1e-5, atol=1e-3, err_msg=name)
            else:
                np.testing.assert_array_equal(got[name], want, err_msg=name)


def test_without_a_group_the_world_is_one_rank():
    assert batch.world() == (1, 0)


@pytest.mark.parametrize("name", ["compute_neighbors_sharded", "dbscan_sharded",
                                  "kmeans_sharded"])
def test_default_call_without_a_card_raises(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default call is valid here")
    pts = cloud()[:16]
    calls = {"compute_neighbors_sharded": lambda: batch.compute_neighbors_sharded(pts, EPS, 2),
             "dbscan_sharded": lambda: batch.dbscan_sharded(pts),
             "kmeans_sharded": lambda: batch.kmeans_sharded(pts, pts[:4])}
    with pytest.raises((RuntimeError, AssertionError)):
        calls[name]()
