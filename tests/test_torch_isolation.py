"""The port stands alone: it imports nothing of the JAX package, its own
copies of `config`, `io` (with its native decoders), OPTICS' host code and
`utils` (ppm, plots, pcd, metrics) stay equal to the JAX package's, and its
entry points (the CLI's `--device` among them) run on the card unless the
caller asks for the CPU."""

import ast
import dataclasses
import inspect
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from evflow_tpu import config as jconfig
from evflow_tpu import io as jio
from evflow_tpu.io import evt2 as jevt2, evt3 as jevt3
from evflow_tpu.models import optics as joptics
from evflow_tpu.utils import metrics as jmetrics, pcd as jpcd, plots as jplots, ppm as jppm
from evflow_tpu_torch import config, fidelity, io, run
from evflow_tpu_torch.io import evt2, evt3
from evflow_tpu_torch.models import aeclustering, dbscan, fastcluster, optics, pipeline, tracker
from evflow_tpu_torch.ops import sae
from evflow_tpu_torch.parallel import batch, mesh, temporal, tiling
from evflow_tpu_torch.utils import metrics, pcd, plots, ppm

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted(str(p.relative_to(ROOT)) for p in (ROOT / "evflow_tpu_torch").rglob("*.py"))
CONFIG_CLASSES = sorted(name for name, obj in vars(jconfig).items()
                        if dataclasses.is_dataclass(obj) and isinstance(obj, type))


def _jax_package_imports(path: Path):
    """Module names of the JAX package that `path` imports."""
    tree = ast.parse(path.read_text(), str(path))
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.append(node.module)
    return [n for n in names if n == "evflow_tpu" or n.startswith("evflow_tpu.")]


@pytest.mark.parametrize("rel", PORT_FILES + ["chip_smoke.py"])
def test_no_import_of_the_jax_package(rel):
    assert _jax_package_imports(ROOT / rel) == [], rel


def test_import_loads_no_module_of_the_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import evflow_tpu_torch\n"
        "for m in pkgutil.walk_packages(evflow_tpu_torch.__path__, 'evflow_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k == 'evflow_tpu' or k.startswith('evflow_tpu.'))\n"
        "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       env=dict(os.environ, PYTHONPATH=str(ROOT)), timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]


def test_default_config_equals_the_jax_package():
    assert dataclasses.asdict(config.DEFAULT) == dataclasses.asdict(jconfig.DEFAULT)


@pytest.mark.parametrize("name", CONFIG_CLASSES)
def test_config_class_equals_the_jax_package(name):
    ours, theirs = getattr(config, name), getattr(jconfig, name)
    assert [(f.name, f.type) for f in dataclasses.fields(ours)] == \
        [(f.name, f.type) for f in dataclasses.fields(theirs)]
    assert dataclasses.asdict(ours()) == dataclasses.asdict(theirs())


def _eq_stream(a, b):
    for f in ("x", "y", "t", "p"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)


def test_load_csv_equals_the_jax_package():
    path = ROOT / "tests" / "data" / "event_raw_data8.csv"
    _eq_stream(io.load_csv(str(path)), jio.load_csv(str(path)))


def test_synthetic_stream_and_slicing_equal_the_jax_package():
    """chip_smoke.py's stream: its arguments and seed."""
    kw = dict(num_slices=32, events_per_slice=16384,
              blob_centers=((200.0, 200.0), (900.0, 500.0), (600.0, 150.0)),
              velocities=((30.0, 10.0), (-20.0, 15.0), (5.0, -12.0)),
              sigma=12.0, seed=42)
    ours, theirs = io.synthetic.moving_blob_stream(**kw), jio.synthetic.moving_blob_stream(**kw)
    _eq_stream(ours, theirs)
    for drop in (True, False):
        a = io.slice_by_count(ours, 16384, drop_partial=drop)
        b = jio.slice_by_count(theirs, 16384, drop_partial=drop)
        for f in ("x", "y", "t", "p"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
        np.testing.assert_array_equal(a.valid_mask(), b.valid_mask())


@pytest.mark.parametrize("fmt", ["evt3", "evt2", "evt21"])
def test_raw_readers_equal_the_jax_package(fmt, tmp_path):
    """The port's copy reads what the JAX package writes, as the JAX
    package's reader does, through the native decoders (the default) and
    through the numpy ones."""
    s = jio.synthetic.moving_blob_stream(num_slices=2, events_per_slice=4096, seed=3)
    path = str(tmp_path / f"s.{fmt}.raw")
    {"evt3": jevt3.save_evt3, "evt2": jevt2.save_evt2, "evt21": jevt2.save_evt21}[fmt](s, path)
    _eq_stream(io.load(path), jio.load(path))
    load, jload = ((evt3.load_evt3, jevt3.load_evt3) if fmt == "evt3"
                   else (evt2.load_evt2, jevt2.load_evt2))
    for use_native in (True, False):
        _eq_stream(load(path, use_native=use_native), s)
        _eq_stream(load(path, use_native=use_native), jload(path, use_native=use_native))


@pytest.mark.parametrize("name", ["load_evt3", "load_evt2"])
def test_raw_loader_signatures_equal_the_jax_package(name):
    mod, jmod = (evt3, jevt3) if name == "load_evt3" else (evt2, jevt2)
    assert inspect.signature(getattr(mod, name)) == inspect.signature(getattr(jmod, name))


ENTRY_POINTS = {
    "pipeline.init_corner_state": lambda: pipeline.init_corner_state(config.DEFAULT),
    "ClusterFlowPipeline.init_state": lambda: pipeline.ClusterFlowPipeline(
        config.DEFAULT).init_state(),
    "ClusterFlowPipeline(exact).init_state": lambda: pipeline.ClusterFlowPipeline(
        config.DEFAULT, mode="exact").init_state(),
    "CornerTrackPipeline.run": lambda: pipeline.CornerTrackPipeline(config.DEFAULT).run(
        io.synthetic.moving_blob_stream(num_slices=1, events_per_slice=16384, seed=1)),
    "fastcluster.init_state": lambda: fastcluster.init_state(),
    "aeclustering.init_state": lambda: aeclustering.init_state(),
    "tracker.init_state": lambda: tracker.init_state(),
    "sae.init_sae": lambda: sae.init_sae(),
    "fidelity.corner_agreement": lambda: fidelity.corner_agreement(8),
    "optics.compute_neighbors_grid": lambda: optics.compute_neighbors_grid(
        np.zeros((4, 2), np.float32), 1.0, 2),
    "dbscan.dbscan_grid": lambda: dbscan.dbscan_grid(np.zeros((4, 2), np.float32)),
    "optics.compute_neighbors": lambda: optics.compute_neighbors(
        np.arange(8.0).reshape(4, 2), 2.0, 2),
    "optics.compute_neighbors_cellpair": lambda: optics.compute_neighbors_cellpair(
        np.arange(8.0).reshape(4, 2), 2.0, 2),
    "optics.compute_reachability_dists": lambda: optics.compute_reachability_dists(
        np.arange(8.0).reshape(4, 2), 2, 2.0),
    "batch.compute_neighbors_sharded": lambda: batch.compute_neighbors_sharded(
        np.arange(8.0).reshape(4, 2), 2.0, 2),
    "batch.dbscan_sharded": lambda: batch.dbscan_sharded(np.zeros((4, 2), np.float32)),
    "batch.kmeans_sharded": lambda: batch.kmeans_sharded(
        np.zeros((4, 2), np.float32), np.zeros((2, 2), np.float32)),
    "run.main": lambda: run.main(["kmeans", "--n", "16"]),
    "tiling.init_tiled_corner_state": lambda: tiling.init_tiled_corner_state(
        mesh.make_tile_mesh(1), 1),
    "temporal.init_blocks": lambda: temporal.init_blocks(8),
    "temporal.run_temporal": lambda: temporal.run_temporal(
        io.slice_by_count(io.synthetic.moving_blob_stream(num_slices=1, events_per_slice=2048,
                                                          seed=1), 2048),
        mesh.make_grid_mesh(1, 1), 1, 1, 0),
    "run.main temporal": lambda: run.main(["temporal", "--windows", "1", "--tiles", "1",
                                           "--input", str(ROOT / "tests" / "data" /
                                                          "event_raw_data8.csv")]),
}


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_default_call_without_a_card_raises(name):
    """The entry points default to the card; with none, a default call
    raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default call is valid here")
    with pytest.raises((RuntimeError, AssertionError, SystemExit)):
        ENTRY_POINTS[name]()


@pytest.mark.parametrize("fn", [pipeline.init_corner_state, fastcluster.init_state,
                                aeclustering.init_state, tracker.init_state,
                                sae.init_sae, fidelity.corner_agreement,
                                optics.compute_neighbors_grid, dbscan.dbscan_grid,
                                optics.compute_neighbors, optics.compute_neighbors_2stage,
                                optics.compute_neighbors_certified,
                                optics.compute_neighbors_cellpair,
                                optics.compute_reachability_dists, optics.neighbor_table,
                                batch.compute_neighbors_sharded, batch.dbscan_sharded,
                                batch.kmeans_sharded, tiling.init_tiled_corner_state,
                                temporal.init_blocks, temporal.run_temporal,
                                temporal.run_temporal_exact])
def test_entry_point_defaults_to_cuda(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"


@pytest.mark.parametrize("argv", [["kmeans"], ["optics", "--input", "x.csv"],
                                  ["cluster-flow", "--input", "x.csv"]])
def test_cli_device_defaults_to_cuda(argv):
    assert run.parser().parse_args(argv).device == "cuda"


@pytest.mark.parametrize("cls", [pipeline.ClusterFlowPipeline, pipeline.CornerTrackPipeline])
def test_pipeline_defaults_to_cuda(cls):
    assert cls(config.DEFAULT).device == "cuda"


# ------------------------------------------- OPTICS' host code and utils/

def _reach(mod, pairs):
    return [mod.ReachabilityDist(i, d) for i, d in pairs]


REACH = [(0, -1.0), (4, 3.0), (2, 2.5), (7, 2.5), (1, 9.0), (3, 1.0), (6, 1.5),
         (5, -1.0), (8, 4.0), (9, 0.5), (10, 0.75), (11, 8.0)]


@pytest.mark.parametrize("points", [np.arange(20.0).reshape(10, 2) ** 1.5,
                                    np.random.default_rng(1).uniform(0, 7, (40, 3)),
                                    np.random.default_rng(2).uniform(0, 1000, (50, 200)),
                                    np.zeros((1, 2)), np.ones((5, 2))])
def test_epsilon_estimation_equals_the_jax_package(points):
    assert optics.epsilon_estimation(points, 4) == joptics.epsilon_estimation(points, 4)


def test_extraction_equals_the_jax_package(tmp_path):
    ours, theirs = _reach(optics, REACH), _reach(joptics, REACH)
    for t in (1.0, 2.5, 5.0):
        assert optics.get_cluster_indices(ours, t) == joptics.get_cluster_indices(theirs, t)
    pts = np.arange(24.0).reshape(12, 2)
    for a, b in zip(optics.get_cluster_points(ours, 2.5, pts),
                    joptics.get_cluster_points(theirs, 2.5, pts)):
        np.testing.assert_array_equal(a, b)
    for chi, min_pts in ((0.1, 2), (0.3, 3), (0.05, 4)):
        flat = optics.get_chi_clusters_flat(ours, chi, min_pts)
        assert flat == joptics.get_chi_clusters_flat(theirs, chi, min_pts)
        assert optics.get_cluster_indices_chi(ours, flat) == \
            joptics.get_cluster_indices_chi(theirs, flat)
        trees = optics.get_chi_clusters(ours, chi, min_pts)
        assert [t.flatten() for t in trees] == \
            [t.flatten() for t in joptics.get_chi_clusters(theirs, chi, min_pts)]
    for replace in (True, False):
        optics.export_reachability_dists(ours, str(tmp_path / "a.csv"), replace)
        joptics.export_reachability_dists(theirs, str(tmp_path / "b.csv"), replace)
        assert (tmp_path / "a.csv").read_bytes() == (tmp_path / "b.csv").read_bytes()


def _draw(mod):
    img = mod.BGRImage(40, 30)
    img.line(1, 1, 35, 20, (10, 20, 30))
    img.line_antialiased(3, 28, 38, 2, (200, 0, 0))
    img.circle(20, 15, 6, (0, 255, 0))
    img.circle(8, 20, 3, (0, 0, 255), filled=True)
    img.arrow(5, 5, 25, 12, (255, 0, 255))
    img.text(2, 29, "12.5 px/f (G3)-", (0, 0, 0))
    return img.append_rows(mod.BGRImage(40, 3, fill=(9, 9, 9)))


def test_ppm_equals_the_jax_package(tmp_path):
    ours, theirs = _draw(ppm), _draw(jppm)
    np.testing.assert_array_equal(ours.px, theirs.px)
    a = Path(ours.save(str(tmp_path / "a"))).read_bytes()
    assert a == Path(theirs.save(str(tmp_path / "b"))).read_bytes()
    np.testing.assert_array_equal(ppm.BGRImage.load(str(tmp_path / "a.ppm")).px, ours.px)


def test_plots_equal_the_jax_package():
    ours, theirs = _reach(optics, REACH), _reach(joptics, REACH)
    pairs = [(plots.draw_reachability_plot(ours), jplots.draw_reachability_plot(theirs)),
             (plots.draw_reachability_plot_with_chi_clusters(ours, 0.1, 2),
              jplots.draw_reachability_plot_with_chi_clusters(theirs, 0.1, 2))]
    rng = np.random.default_rng(4)
    clusters = [rng.uniform(0, 60, (9, 2)), rng.uniform(20, 90, (5, 2))]
    pairs.append((plots.draw_2d_clusters(clusters), jplots.draw_2d_clusters(clusters)))
    for a, b in pairs:
        np.testing.assert_array_equal(a.px, b.px)


def test_frame_renders_equal_the_jax_package():
    from types import SimpleNamespace as NS
    rng = np.random.default_rng(5)
    out = NS(reported=np.array([True, False, True]), centroid=rng.uniform(20, 80, (3, 2)),
             flow=rng.normal(0, 4, (3, 2)), cid=np.array([3, 1, 12]))
    mx, my = rng.integers(0, 100, 50), rng.integers(0, 80, 50)
    labels = rng.integers(-1, 3, 50)
    a = plots.render_cluster_frame(100, 80, out, (mx, my), labels)
    b = jplots.render_cluster_frame(100, 80, out, (mx, my), labels)
    np.testing.assert_array_equal(a.px, b.px)
    groups = NS(exists=np.array([True, True, False]), centroid=rng.uniform(20, 80, (3, 2)),
                avg_velocity=np.array([[2.0, 1.0], [0.01, 0.0], [1.0, 1.0]]),
                radius=np.array([6.0, 1.0, 3.0]))
    track = NS(groups=groups, track_active=np.array([True, True, False, True]),
               track_pos=rng.uniform(5, 95, (4, 2)), track_group=np.array([0, -1, 1, 1]),
               track_label=np.array([4, 7, 9, 11]), track_frames_since=np.array([0, 1, 0, 2]),
               track_frame_count=np.array([5, 3, 9, 2]))
    np.testing.assert_array_equal(plots.render_track_frame(100, 80, track).px,
                                  jplots.render_track_frame(100, 80, track).px)


def test_pcd_equals_the_jax_package(tmp_path):
    rng = np.random.default_rng(6)
    pts = rng.normal(0, 1, (40, 3)).astype(np.float32)
    inten = rng.integers(0, 8, 40).astype(np.float32)
    for binary in (False, True):
        for i in (None, inten):
            a, b = str(tmp_path / "a.pcd"), str(tmp_path / "b.pcd")
            pcd.save_pcd(a, pts, i, binary=binary)
            jpcd.save_pcd(b, pts, i, binary=binary)
            assert Path(a).read_bytes() == Path(b).read_bytes()
            for got, want in zip(pcd.load_pcd(a), jpcd.load_pcd(a)):
                np.testing.assert_array_equal(got, want)


def test_metrics_equal_the_jax_package():
    rng = np.random.default_rng(7)
    ta = {k: [tuple(p) for p in rng.normal(0, 5, (n, 2))] for k, n in ((1, 5), (2, 3), (4, 6))}
    tb = {k: [tuple(p) for p in rng.normal(0, 5, (n, 2))] for k, n in ((1, 4), (3, 2), (4, 6))}
    for a, b in ((ta, tb), (tb, ta), ({}, tb), (ta, {})):
        assert metrics.ate(a, b) == jmetrics.ate(a, b)
        assert metrics.trajectory_coverage(a, b) == jmetrics.trajectory_coverage(a, b)
    la, lb = rng.integers(-1, 4, 60), rng.integers(-1, 4, 60)
    assert metrics.cluster_set_agreement(la, lb) == jmetrics.cluster_set_agreement(la, lb)
    flow, gt = rng.normal(0, 3, (6, 2)), rng.normal(0, 3, (6, 2))
    assert metrics.flow_endpoint_error(flow, gt) == jmetrics.flow_endpoint_error(flow, gt)
    cents, gc, gv = rng.uniform(0, 100, (6, 2)), rng.uniform(0, 100, (3, 2)), rng.normal(0, 3, (3, 2))
    assert metrics.greedy_match_flow(flow, cents, gc, gv) == \
        jmetrics.greedy_match_flow(flow, cents, gc, gv)
