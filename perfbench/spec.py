"""What a cell is made of, found by name.

`BENCHMARK.json` at the root of the checkout names the cells, the
configurations, the traffic mixes and the metrics. Every piece lives in a
file of its own under `perfbench/`, so a later change adds a cell, a
configuration, a traffic mix, a scene, a path, a metric or a kernel by adding
files and entries, and edits none:

- a configuration: `configs/<name>.json`, as the benchmark file's `file`
  names it; its `"path"` names `paths/<path>.py`;
- its comparison's limits and the slices the reference recomputes:
  `limits/<configuration>.json`;
- a traffic mix: `traffic/<name>.json`; its `"scene"` names `scenes/<scene>.py`;
- a per-layer metric `<base>.<twin>`: `metrics/<base>.py`, or for a base
  `<kernel>_roofline`, `metrics/roofline.py` with `kernels/<kernel>.py`.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
ROOFLINE_SUFFIX = "_roofline"


def load_module(path: Path) -> ModuleType:
    """Import one plug-in file by its path, under a name of its folder."""
    name = f"perfbench_{path.parent.name}_{path.stem}"
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    better: str
    source: str
    entry: dict

    @property
    def base(self) -> str:
        return self.name.split(".", 1)[0]


@dataclasses.dataclass
class Cell:
    """One workload: a configuration under a traffic mix, with the metrics
    it reports."""
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    limits: dict
    check: dict
    end_to_end: list
    per_layer: list
    root: Path = HERE

    def path_module(self) -> ModuleType:
        return load_module(self.root / "paths" / f"{self.config['path']}.py")

    def scene_module(self) -> ModuleType:
        return load_module(self.root / "scenes" / f"{self.traffic['scene']}.py")

    def metric_reader(self, metric: Metric):
        """(reader module, kernel module or None) of a per-layer metric."""
        base = metric.base
        own = self.root / "metrics" / f"{base}.py"
        if own.exists():
            return load_module(own), None
        if base.endswith(ROOFLINE_SUFFIX):
            kernel = base[:-len(ROOFLINE_SUFFIX)]
            return (load_module(self.root / "metrics" / "roofline.py"),
                    load_module(self.root / "kernels" / f"{kernel}.py"))
        raise FileNotFoundError(f"no reader for per-layer metric {metric.name}: {own}")


def _metrics(entries: list) -> list:
    return [Metric(e["name"], e["unit"], e["better"], e["source"], e) for e in entries]


def _reports(entry: dict, cell: str, e2e_names: Optional[set]) -> bool:
    if "workloads" in entry:
        return cell in entry["workloads"]
    if e2e_names is None:
        return True
    return entry["moves"] in e2e_names


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell `name` of `root`/BENCHMARK.json with everything it names."""
    bench = read_json(root / "BENCHMARK.json")
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(work)}")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    pb = root / "perfbench"
    config = read_json(root / conf["file"])
    traffic = read_json(pb / "traffic" / f"{w['traffic']}.json")
    comparison = read_json(pb / "limits" / f"{w['config']}.json")
    e2e = [m for m in _metrics(bench["end_to_end"]) if _reports(m.entry, name, None)]
    names = {m.name for m in e2e}
    per_layer = [m for m in _metrics(bench["per_layer"]) if _reports(m.entry, name, names)]
    return Cell(name=name, chips=w["chips"], config_name=w["config"], config=config,
                traffic_name=w["traffic"], traffic=traffic,
                limits=comparison["limits"], check=comparison["check"],
                end_to_end=e2e, per_layer=per_layer, root=pb)
