"""Path `optics_scan`: app B's OPTICS on each slice of a call's (S, N)
slices, `models.pipeline.optics_scan` (an exact-width neighbour table on the
card, the host sweep, the threshold split and each cluster's statistics),
and the plain PyTorch reference that recomputes it (`reference/optics.py`).
The system interface is `full_scan.py`'s. OPTICS carries nothing across
slices: the state is the count of slices run. The reachability threshold
is the configuration's `extraction` group, which the program's config
lacks: the path reads it and passes it to the scan."""

from __future__ import annotations

import numpy as np
import torch

from perfbench import compare
from perfbench.reference import optics as ref_optics
from perfbench.systems import engine_config, to_host

# integer pixels: every distance is a correctly rounded square root of an
# exact integer, so the order, reach, membership, count and sizes are
# compared exactly; centroids and standard deviations are float32
DISCRETE = ("order", "reach", "cluster", "num_clusters", "size")
FLOATS = ("centroid", "std")
OUT = DISCRETE + ("centroid", "variance")
GROUPS = ("sensor", "slicing", "optics")


def numbers(prog: dict, ref: dict) -> dict:
    def px(out):
        # the standard deviations, so that the gap is in pixels
        return {"centroid": out["centroid"],
                "std": np.sqrt(np.asarray(out["variance"], np.float64))}
    return {"discrete_mismatches": compare.discrete_mismatches(prog, ref, DISCRETE),
            "float_gap_px": compare.float_gap_px(px(prog), px(ref), FLOATS)}


class Program:
    def __init__(self, cfg: dict, device: torch.device):
        from evflow_tpu_torch.models import pipeline
        self.ecfg = engine_config(cfg, GROUPS)
        self.threshold = float(cfg["extraction"]["threshold"])
        self.scan = pipeline.optics_scan
        self.device = device

    def init(self):
        return torch.zeros((), dtype=torch.int32, device=self.device)

    def step(self, state, x, y, t, valid):
        return self.scan(state, x, y, t, valid, self.ecfg, self.threshold)

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
            outs.append(ref_optics.cluster_slice(xs, ys, vs, self.cfg, self.control, counts))
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
