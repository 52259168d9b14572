"""The port stands alone: it imports nothing of the JAX package, its own
copies of `config` and `io` stay equal to the JAX package's, and its entry
points run on the card unless the caller asks for the CPU."""

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
from evflow_tpu_torch import config, fidelity, io
from evflow_tpu_torch.io import evt2, evt3
from evflow_tpu_torch.models import aeclustering, dbscan, fastcluster, optics, pipeline, tracker
from evflow_tpu_torch.ops import sae

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
    """The numpy decoders of the port's copy read what the JAX package
    writes, as the JAX package's reader does."""
    s = jio.synthetic.moving_blob_stream(num_slices=2, events_per_slice=4096, seed=3)
    path = str(tmp_path / f"s.{fmt}.raw")
    {"evt3": jevt3.save_evt3, "evt2": jevt2.save_evt2, "evt21": jevt2.save_evt21}[fmt](s, path)
    _eq_stream(io.load(path), jio.load(path))
    load = evt3.load_evt3 if fmt == "evt3" else evt2.load_evt2
    _eq_stream(load(path), s)


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
}


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_default_call_without_a_card_raises(name):
    """The entry points default to the card; with none, a default call
    raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default call is valid here")
    with pytest.raises((RuntimeError, AssertionError)):
        ENTRY_POINTS[name]()


@pytest.mark.parametrize("fn", [pipeline.init_corner_state, fastcluster.init_state,
                                aeclustering.init_state, tracker.init_state,
                                sae.init_sae, fidelity.corner_agreement,
                                optics.compute_neighbors_grid, dbscan.dbscan_grid])
def test_entry_point_defaults_to_cuda(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"


@pytest.mark.parametrize("cls", [pipeline.ClusterFlowPipeline, pipeline.CornerTrackPipeline])
def test_pipeline_defaults_to_cuda(cls):
    assert cls(config.DEFAULT).device == "cuda"
