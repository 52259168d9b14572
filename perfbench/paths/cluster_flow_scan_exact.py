"""Path `cluster_flow_scan_exact`: the program's exact clustering path,
`models.pipeline.cluster_flow_scan_exact` over a call's (S, N) slices (hash
dedup, the exact AEClustering engine, cid-keyed centroid flow), and the
NumPy reference that recomputes it (`reference/exact.py`). The system
interface is `full_scan.py`'s."""

from __future__ import annotations

import copy

import numpy as np
import torch

from perfbench import compare
from perfbench.reference import exact as ref_exact
from perfbench.systems import clone, engine_config, to_host

DISCRETE = ("unique_count", "repeated_count", "reported", "cid", "n")
FLOATS = ("centroid", "flow")


def numbers(prog: dict, ref: dict) -> dict:
    """The engine is exact, so every field is compared as it stands."""
    return {"discrete_mismatches": compare.discrete_mismatches(prog, ref, DISCRETE),
            "float_gap_px": compare.float_gap_px(prog, ref, FLOATS)}
GROUPS = ("sensor", "slicing", "dedup", "cluster", "flow")


class Program:
    def __init__(self, cfg: dict, device: torch.device):
        from evflow_tpu_torch.models import pipeline
        self.ecfg = engine_config(cfg, GROUPS)
        self.pipeline, self.device = pipeline, device

    def init(self):
        return self.pipeline.ClusterFlowPipeline(self.ecfg, mode="exact",
                                                 device=str(self.device)).init_state()

    def step(self, state, x, y, t, valid):
        return self.pipeline.cluster_flow_scan_exact(state, x, y, t, valid, self.ecfg)

    def host(self, out):
        return to_host(out._asdict())

    def snapshot(self, state):
        return clone(state)


def _np(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


class Reference:
    def __init__(self, cfg: dict, device: torch.device, float_round=None):
        self.cfg = cfg
        self.float_round = float_round

    def _path(self):
        if self.float_round is None:
            return ref_exact.ExactPath(self.cfg)
        return ref_exact.ExactPath(self.cfg, self.float_round)

    def init(self):
        return self._path().state

    def adopt(self, snap):
        """The program's state (AEState, cum, prev_cid, prev_cent), or this
        reference's own, as NumPy."""
        if isinstance(snap[0], dict):
            return copy.deepcopy(snap)
        ae, cum, prev_cid, prev_cent = snap
        st = {}
        for f in ref_exact.STATE_FIELDS:
            v = _np(getattr(ae, f))
            st[f] = v.item() if v.ndim == 0 else v.copy()
        return st, int(_np(cum)), _np(prev_cid).astype(np.int32), _np(prev_cent).astype(np.float32)

    def step(self, state, x, y, t, valid, counts=None):
        path = self._path()
        path.state = state
        x, y, t, valid = (_np(a) for a in (x, y, t, valid))
        outs = [path.step(x[s], y[s], t[s], valid[s], counts) for s in range(x.shape[0])]
        return path.state, {f: np.stack([np.asarray(o[f]) for o in outs]) for f in outs[0]}

    def host(self, out):
        return out

    def snapshot(self, state):
        return copy.deepcopy(state)


def program(cfg: dict, device: torch.device):
    return Program(cfg, device)


def reference(cfg: dict, device: torch.device, control: bool = False):
    """The reference; with `control`, every stored cluster mean rounded to
    bfloat16, the precision below the float32 the configuration states."""
    return Reference(cfg, device, ref_exact.bf16_scalar if control else None)


def prepare() -> None:
    """The reference runs on the host and needs nothing of the card."""
