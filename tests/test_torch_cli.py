"""The port's CLI (python -m evflow_tpu_torch.run) on the CPU: the JAX
package's CLI smoke cases (tests/test_cli.py), then each subcommand's
output against `evflow_tpu.run.main` on the same input, line by line.

Lines are compared parsed: the text between numbers equal, integer fields
equal, float fields within 0.01 (a last printed digit at a rounding
boundary) plus the model's stated tolerance (rtol 1e-5, atol 1e-3: the
fast path's centroids agree with JAX within f32 reduction order, not bit
for bit). `Total time` lines are left out. Frame PPMs are compared byte
for byte.
"""

import json
import os
import re
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from evflow_tpu.run import main as jax_main
from evflow_tpu_torch.io import save_csv, synthetic
from evflow_tpu_torch.run import main
from evflow_tpu_torch.utils import pcd

ROOT = Path(__file__).resolve().parent.parent
FIXTURE = str(ROOT / "tests" / "data" / "event_raw_data8.csv")
CPU = ["--device", "cpu"]
RTOL, ATOL, PRINT_TOL = 1e-5, 1e-3, 0.01
_NUM = re.compile(r"(-?\d+(?:\.\d*)?(?:e[-+]?\d+)?)")


@pytest.fixture(scope="module")
def small_stream(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("ev") / "small.csv")
    s = synthetic.moving_blob_stream(num_slices=2, events_per_slice=2048,
                                     blob_centers=((300.0, 300.0),),
                                     velocities=((10.0, 5.0),))
    save_csv(s, p)
    return p


@pytest.fixture(scope="module")
def blobs(tmp_path_factory):
    """Two DEFAULT slices of chip_smoke.py's three-blob stream: corners and
    flows appear in slice 1."""
    p = str(tmp_path_factory.mktemp("ev") / "blobs.csv")
    s = synthetic.moving_blob_stream(
        num_slices=2, events_per_slice=16384,
        blob_centers=((200.0, 200.0), (900.0, 500.0), (600.0, 150.0)),
        velocities=((30.0, 10.0), (-20.0, 15.0), (5.0, -12.0)), sigma=12.0, seed=42)
    save_csv(s, p)
    return p


@pytest.fixture(scope="module")
def cloud_pcd(tmp_path_factory):
    """App C's scene, small: a plane at z = 0.3 and two blobs above it."""
    rng = np.random.default_rng(3)
    plane = np.stack([rng.uniform(0, 1, 3000), rng.uniform(0, 1, 3000),
                      0.3 + rng.normal(0, 0.005, 3000)], 1)
    pts = np.concatenate([plane, rng.normal((0.3, 0.3, 0.5), 0.03, (600, 3)),
                          rng.normal((0.7, 0.6, 0.55), 0.03, (600, 3))]).astype(np.float32)
    p = str(tmp_path_factory.mktemp("pc") / "cloud.pcd")
    pcd.save_pcd(p, pts)
    return p


def _run(fn, argv, capsys):
    fn(argv)
    return capsys.readouterr().out


def assert_lines_match(got: str, want: str, rtol=RTOL, atol=ATOL):
    got = [ln for ln in got.splitlines() if not ln.startswith("Total time")]
    want = [ln for ln in want.splitlines() if not ln.startswith("Total time")]
    assert len(got) == len(want), (got, want)
    for a, b in zip(got, want):
        pa, pb = _NUM.split(a), _NUM.split(b)
        assert len(pa) == len(pb) and pa[::2] == pb[::2], (a, b)
        for x, y in zip(pa[1::2], pb[1::2]):
            if "." in x + y or "e" in x + y:
                assert abs(float(x) - float(y)) <= PRINT_TOL + atol + rtol * abs(float(y)), (a, b)
            else:
                assert int(x) == int(y), (a, b)


def _ppms(d):
    return {f: (Path(d) / f).read_bytes() for f in sorted(os.listdir(d))}


# ------------------------------------------- tests/test_cli.py's cases

def test_cli_kmeans(capsys):
    assert "iters=" in _run(main, ["kmeans", "--n", "512"] + CPU, capsys)


def test_cli_optics(capsys):
    out = _run(main, ["optics", "--input", FIXTURE, "--eps", "10", "--threshold", "10"] + CPU,
               capsys)
    assert "Cluster size" in out


def test_cli_sampling(small_stream, capsys):
    out = _run(main, ["sampling", "--input", small_stream] + CPU, capsys)
    assert "unique=" in out and "Total time" in out


def test_cli_async_cluster(capsys):
    out = _run(main, ["async-cluster", "--input", FIXTURE, "--decimate", "1"] + CPU, capsys)
    assert "clusters=" in out


def test_cli_cluster_flow(small_stream, capsys, tmp_path):
    out = _run(main, ["cluster-flow", "--input", small_stream, "--out", str(tmp_path)] + CPU,
               capsys)
    assert "unique=" in out
    assert any(f.endswith(".ppm") for f in os.listdir(tmp_path))


def test_cli_track_estimate(small_stream, capsys):
    out = _run(main, ["track-estimate", "--input", small_stream, "--decimate", "2"] + CPU,
               capsys)
    assert "velocity arrows" in out


def test_cli_corner_track(small_stream, capsys):
    assert "corners=" in _run(main, ["corner-track", "--input", small_stream] + CPU, capsys)


TEMPORAL_1X1 = ["temporal", "--windows", "1", "--tiles", "1", "--warmup", "2"]
# eps 3 px: small neighbourhoods, a few propagation rounds per slice
DBSCAN_SMALL = ["--eps", "3", "--min-pts", "5", "--min-cluster-size", "50"]
TRACED = {
    # argv, slices run per slice printed beyond it (temporal's warm-up),
    # spans the trace must hold besides `slice`
    "cluster-flow": (["cluster-flow"], 0, {"dedup", "fastcluster"}),
    "corner-track": (["corner-track"], 0, {"sae", "efast", "nms", "tracker"}),
    "temporal": (TEMPORAL_1X1, 2, {"dedup", "fastcluster", "sae", "efast", "nms",
                                   "nms.round", "tracker"}),
    "temporal-exact": (TEMPORAL_1X1 + ["--exact"], 2, {"dedup", "exact_engine"}),
    "dbscan-per-slice": (["dbscan", "--per-slice"] + DBSCAN_SMALL, 0,
                         {"dbscan", "dbscan.dense", "dbscan.round"}),
    "optics-slice-events": (["optics", "--slice-events", "1024"], 0,
                            {"optics", "optics.table", "optics.sweep", "optics.extract"}),
}


@pytest.mark.parametrize("case", TRACED)
def test_cli_trace_writes_slice_spans(case, small_stream, capsys, tmp_path):
    """`--trace DIR` writes DIR/trace.json with one `slice` span per slice
    run (temporal also runs its warm-up slices), the spans of the modules
    that the run enters, and prints what the untraced run prints."""
    argv, warm, spans = TRACED[case]
    argv = argv + ["--input", small_stream] + CPU
    plain = _run(main, argv, capsys)
    d = tmp_path / "trace"
    out = _run(main, argv + ["--trace", str(d)], capsys)
    assert out == plain
    with open(d / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    names = [e["name"] for e in events if e.get("cat") == "user_annotation"]
    printed = sum(re.match(r"(window \d+ )?slice \d+", ln) is not None
                  for ln in out.splitlines())
    assert names.count("slice") == printed + warm > warm
    assert spans <= set(names), spans - set(names)


def test_cli_dbscan_per_slice(small_stream, capsys):
    """`dbscan --per-slice` prints each slice's clusters as dbscan_grid finds
    them on that slice's events, largest first."""
    from evflow_tpu_torch.config import DEFAULT, DBSCANConfig
    from evflow_tpu_torch.io import load, slice_by_count
    from evflow_tpu_torch.models.dbscan import dbscan_grid
    out = _run(main, ["dbscan", "--per-slice", "--input", small_stream] + DBSCAN_SMALL + CPU,
               capsys)
    sl = slice_by_count(load(small_stream), DEFAULT.slicing.n_events)
    want = []
    for i in range(sl.num_slices):
        n = int(sl.count[i])
        pts = np.stack([sl.x[i, :n], sl.y[i, :n]], 1).astype(np.float32)
        res = dbscan_grid(pts, DBSCANConfig(eps=3.0, core_min_pts=5, min_cluster_size=50),
                          device="cpu")
        labels, k = res.labels.numpy(), int(res.num_clusters)
        want.append(f"slice {i}: events={n} clusters={k} iterations={int(res.iterations)}")
        for c in range(k):
            m = pts[labels == c]
            want.append(f"  cluster {c}: size={len(m)} "
                        f"centroid=({m[:, 0].mean():.2f},{m[:, 1].mean():.2f})")
    assert k > 0
    assert_lines_match(out, "\n".join(want))


def test_cli_optics_slice_events(capsys):
    """`optics --slice-events N` prints app B's report for each N-event
    slice of the committed fixture (the last one short), as
    compute_reachability_dists and get_cluster_indices give it on that
    slice's events; the whole-file report stays the golden one."""
    from evflow_tpu_torch.io import load, slice_by_count
    from evflow_tpu_torch.models import optics
    out = _run(main, ["optics", "--slice-events", "128", "--input", FIXTURE] + CPU, capsys)
    sl = slice_by_count(load(FIXTURE), 128)
    want, most = [], 0
    for i in range(sl.num_slices):
        n = int(sl.count[i])
        pts = np.stack([sl.x[i, :n], sl.y[i, :n]], 1).astype(np.float64)
        rd = optics.compute_reachability_dists(pts, 2, 10.0, device="cpu")
        clusters = optics.get_cluster_indices(rd, 10.0)
        most = max(most, len(clusters))
        want += [f"slice {i}: events={n}", f"Cluster size : {len(clusters)}"]
        for j, c in enumerate(clusters):
            p = pts[np.asarray(c, int)]
            want.append(f"{j},{len(c)},{p[:, 0].mean():g},{p[:, 1].mean():g},"
                        f"{p[:, 0].var():g},{p[:, 1].var():g}")
    assert sl.count.tolist() == [128, 128, 64] and most > 5
    assert_lines_match(out, "\n".join(want))
    whole = _run(main, ["optics", "--input", FIXTURE, "--eps", "10", "--threshold", "10"] + CPU,
                 capsys)
    with open(ROOT / "tests" / "data" / "golden_optics_data8.txt") as f:
        assert whole == f.read()


def test_cli_optics_chi_and_plots(tmp_path, capsys):
    out = str(tmp_path / "frames")
    text = _run(main, ["optics", "--input", FIXTURE, "--eps", "10", "--chi", "0.1",
                       "--out", out] + CPU, capsys)
    assert "Cluster size" in text
    assert sorted(os.listdir(out)) == ["clusters_2d.ppm", "reachability_plot.ppm"]
    with open(os.path.join(out, "reachability_plot.ppm"), "rb") as f:
        assert f.read(2) == b"P6"


def test_cli_cluster_flow_exact(small_stream, capsys):
    out = _run(main, ["cluster-flow", "--input", small_stream, "--exact",
                      "--fabricated-ts"] + CPU, capsys)
    assert "unique=" in out and "clusters=" in out


# ------------------------------------------- parity with evflow_tpu.run

PARITY = {
    "cluster-flow": ("blobs", ["cluster-flow"]),
    "cluster-flow-exact": ("blobs", ["cluster-flow", "--exact"]),
    "cluster-flow-exact-fabricated": ("small_stream", ["cluster-flow", "--exact",
                                                       "--fabricated-ts"]),
    "async-cluster-fixture": ("fixture", ["async-cluster", "--decimate", "1"]),
    "async-cluster": ("blobs", ["async-cluster", "--decimate", "8"]),
    "track-estimate": ("blobs", ["track-estimate", "--decimate", "2"]),
    "corner-track": ("blobs", ["corner-track"]),
    "kmeans": (None, ["kmeans", "--n", "2048"]),
    "kmeans-sharded": (None, ["kmeans", "--n", "2048", "--sharded"]),
    "sampling": ("blobs", ["sampling"]),
    "optics": ("fixture", ["optics", "--eps", "10"]),
    "optics-sharded": ("fixture", ["optics", "--eps", "10", "--method", "sharded"]),
    "optics-chi": ("fixture", ["optics", "--eps", "10", "--chi", "0.1"]),
    "dbscan": ("small_stream", ["dbscan", "--eps", "20"]),
    "dbscan-sharded": ("small_stream", ["dbscan", "--eps", "20", "--sharded"]),
    "dbscan-pcd": ("cloud_pcd", ["dbscan", "--voxel", "0.01", "--remove-plane",
                                 "--eps", "0.05", "--min-pts", "10"]),
}
FRAMES = {"cluster-flow", "corner-track", "optics-chi"}


@pytest.mark.parametrize("case", list(PARITY))
def test_cli_output_equals_the_jax_package(case, request, capsys, tmp_path):
    source, argv = PARITY[case]
    if source is not None:
        path = FIXTURE if source == "fixture" else request.getfixturevalue(source)
        argv = argv + ["--input", path]
    extra = {}
    for name in ("jax", "port"):
        extra[name] = []
        if case in FRAMES:
            extra[name] += ["--out", str(tmp_path / name)]
        if case.startswith("dbscan"):
            ext = ".pcd" if case == "dbscan-pcd" else ".csv"
            extra[name] += ["--export", str(tmp_path / f"{name}{ext}")]
    want = _run(jax_main, argv + extra["jax"], capsys)
    got = _run(main, argv + extra["port"] + CPU, capsys)
    assert_lines_match(got, want)
    if case.startswith("optics"):
        assert got == want
    if case in FRAMES:
        assert _ppms(tmp_path / "port") == _ppms(tmp_path / "jax")
    if case.startswith("dbscan"):
        assert (tmp_path / f"port{ext}").read_bytes() == (tmp_path / f"jax{ext}").read_bytes()


# ------------------------------------------- the card, temporal, torchrun

def test_device_cuda_without_a_card_exits_nonzero(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: --device cuda is valid here")
    for argv in (["kmeans"], ["--device", "cuda", "kmeans"], ["kmeans", "--device", "cuda"]):
        with pytest.raises(SystemExit) as e:
            main(argv)
        assert e.value.code not in (0, None)
        assert "no CUDA device" in str(e.value.code)
    assert capsys.readouterr().out == ""


def test_device_flag_defaults_to_cuda():
    from evflow_tpu_torch.run import parser
    assert parser().parse_args(["kmeans"]).device == "cuda"
    assert parser().parse_args(["kmeans", "--device", "cpu"]).device == "cpu"
    assert parser().parse_args(["--device", "cpu", "kmeans"]).device == "cpu"


def test_temporal_exits_with_its_message(small_stream):
    """Outside torchrun there is one rank: a larger grid (the default 2 x 4)
    exits naming the ranks it needs, as the JAX CLI names the devices."""
    for argv, msg in ((["temporal"], "grid (2x4) needs 8 ranks, have 1"),
                      (["temporal", "--exact", "--windows", "3"], "windows needs 3 ranks, have 1")):
        with pytest.raises(SystemExit) as e:
            main(argv + ["--input", small_stream] + CPU)
        assert msg in str(e.value.code), e.value.code


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("case", ["kmeans-sharded", "dbscan-sharded"])
def test_two_ranks_under_torchrun_env(case, small_stream, capsys):
    """WORLD_SIZE=2 as torchrun sets it: the ranks form a Gloo group, split
    the rows, and only rank 0 prints, the one-rank run's lines."""
    source, argv = PARITY[case]
    if source is not None:
        argv = argv + ["--input", small_stream]
    want = _run(main, argv + CPU, capsys)
    env = dict(os.environ, WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()), PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-m", "evflow_tpu_torch.run", *CPU, *argv],
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], [o[1][-2000:] for o in outs]
    assert_lines_match(outs[0][0], want)
    assert outs[1][0] == ""


def test_two_ranks_trace_one_file_each(small_stream, tmp_path):
    """`temporal --trace DIR` under two ranks: rank 0 writes DIR/trace.json,
    rank 1 DIR/rank1/trace.json, each with its window's slice spans."""
    d = tmp_path / "trace"
    argv = ["temporal", "--exact", "--windows", "2", "--warmup", "2",
            "--input", small_stream, "--trace", str(d)]
    env = dict(os.environ, WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()), PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-m", "evflow_tpu_torch.run", *CPU, *argv],
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], [o[1][-2000:] for o in outs]
    for path in (d / "trace.json", d / "rank1" / "trace.json"):
        with open(path) as f:
            names = [e["name"] for e in json.load(f)["traceEvents"]
                     if e.get("cat") == "user_annotation"]
        assert names.count("slice") > 0 and "exact_engine" in names
