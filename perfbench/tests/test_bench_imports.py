"""Nothing the benchmark runs imports JAX or the JAX package, with
top-level module names compared whole; the reference imports nothing of the
program either."""

import ast
import subprocess
import sys

from conftest import ROOT
from perfbench import harness

PB = ROOT / "perfbench"


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_whole_names(monkeypatch):
    for name in ("evflow_tpu_torch", "evflow_tpu_torch.models", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert harness.forbidden_modules() == []
    for name, top in (("evflow_tpu.config", "evflow_tpu"), ("jax.numpy", "jax"),
                      ("jaxlib", "jaxlib"), ("flax.linen", "flax")):
        monkeypatch.setitem(sys.modules, name, sys)
        assert top in harness.forbidden_modules()


def test_sources_import_no_jax():
    for f in PB.rglob("*.py"):
        tops = set(_imports(f))
        assert not tops & set(harness.FORBIDDEN), f
        if "reference" in f.parts:
            assert "evflow_tpu_torch" not in tops, f


def test_a_run_loads_no_jax():
    code = ("import sys, torch; sys.path.insert(0, 'perfbench/tests');"
            "from conftest import small_cell; from perfbench import harness;"
            "harness.run_cell(small_cell('exact_textured_live', 'blobs_replay'), 3, 0.2,"
            " False, torch.device('cpu'), log=lambda *a: None);"
            "print(harness.forbidden_modules())")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"
