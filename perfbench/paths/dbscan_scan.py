"""Path `dbscan_scan`: app C's DBSCAN on each slice of a call's (S, N)
slices, `models.pipeline.dbscan_scan` (the grid's table where it applies
and holds every neighbourhood, dense panels otherwise), and the plain
PyTorch reference that recomputes it (`reference/dbscan.py`). The system
interface is `full_scan.py`'s. DBSCAN carries nothing across slices: the
state is the count of slices run."""

from __future__ import annotations

import torch

from perfbench import compare
from perfbench.reference import dbscan as ref_dbscan
from perfbench.systems import engine_config, to_host

# integer pixels: every distance is exact, so labels, core mask and counts are
# compared exactly; centroids are float32 means
DISCRETE = ("labels", "core", "num_clusters", "size")
FLOATS = ("centroid",)
OUT = DISCRETE + FLOATS
GROUPS = ("sensor", "slicing", "dbscan")


def numbers(prog: dict, ref: dict) -> dict:
    return {"discrete_mismatches": compare.discrete_mismatches(prog, ref, DISCRETE),
            "float_gap_px": compare.float_gap_px(prog, ref, FLOATS)}


class Program:
    def __init__(self, cfg: dict, device: torch.device):
        from evflow_tpu_torch.models import pipeline
        self.ecfg = engine_config(cfg, GROUPS)
        self.scan = pipeline.dbscan_scan
        self.device = device

    def init(self):
        return torch.zeros((), dtype=torch.int32, device=self.device)

    def step(self, state, x, y, t, valid):
        return self.scan(state, x, y, t, valid, self.ecfg)

    def host(self, out):
        return to_host({f: getattr(out, f) for f in OUT})

    def snapshot(self, state):
        return state.clone()


class Reference:
    def __init__(self, cfg: dict, device: torch.device, control: bool = False):
        self.cfg, self.device, self.control = cfg, device, control

    def init(self):
        return 0

    def adopt(self, snap):
        return int(snap)

    def step(self, state, x, y, t, valid, counts=None):
        outs = []
        for s in range(x.shape[0]):
            xs, ys, vs = (torch.as_tensor(a[s], device=self.device) for a in (x, y, valid))
            outs.append(ref_dbscan.cluster_slice(xs, ys, vs, self.cfg, self.control, counts))
        return state + x.shape[0], compare.stack(outs)

    def host(self, out):
        return out

    def snapshot(self, state):
        return state


def program(cfg: dict, device: torch.device):
    return Program(cfg, device)


def reference(cfg: dict, device: torch.device, control: bool = False):
    """The reference; with `control`, the coordinates rounded to bfloat16,
    the precision below the float32 the configuration states."""
    return Reference(cfg, device, control)


def prepare() -> None:
    """The reference needs no TF32 in any matmul; it sets that itself."""
