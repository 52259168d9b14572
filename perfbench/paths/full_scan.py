"""Path `full_scan`: the program's `models.pipeline.full_scan`, both chains
per slice over a call's (S, N) slices, and the reference that recomputes it
(`reference/track.py`).

The system interface the harness drives (the program, or the reference put
in its place as the control): `init()`, `step(state, x, y, t, valid)` on
(S, N) device tensors, `host(out)` (field -> (S, ...) NumPy, on the host),
`snapshot(state)` (a copy on the device). The reference adds `adopt(state)`,
which takes a snapshot of either side as its own state, and `step(...,
counts)`, which records the work counts of each slice.
"""

from __future__ import annotations

import torch

from perfbench import compare
from perfbench.reference import track as ref_track
from perfbench.systems import clone, engine_config, to_host

# fields that f32 summation order cannot reach: dedup and the corner chain
# (integer surfaces, corners and NMS; the tracker runs the same ops on both
# sides), compared exactly; the cluster chain as multisets of clusters
DISCRETE = ("unique_count", "repeated_count", "num_corners", "num_filtered", "num_dropped",
            "track_active", "track_label", "track_group", "track_frames_since",
            "track_frame_count", "groups_exists", "groups_size")
FLOATS = ("track_pos", "track_vel", "groups_centroid", "groups_avg_velocity", "groups_radius")


def numbers(prog: dict, ref: dict) -> dict:
    return {"discrete_mismatches": compare.discrete_mismatches(prog, ref, DISCRETE),
            "float_gap_px": compare.float_gap_px(prog, ref, FLOATS),
            "unmatched_clusters": compare.unmatched_clusters(prog, ref)}


CLUSTER_OUT = ("unique_count", "repeated_count", "reported", "cid", "n", "centroid", "flow")
CORNER_OUT = ("num_corners", "num_filtered", "num_dropped", "track_active", "track_label",
              "track_pos", "track_vel", "track_group", "track_frames_since",
              "track_frame_count")
GROUP_OUT = ("exists", "centroid", "avg_velocity", "radius", "size")
GROUPS = ("sensor", "slicing", "dedup", "cluster", "efast", "nms", "tracker", "flow")


class Program:
    def __init__(self, cfg: dict, device: torch.device):
        from evflow_tpu_torch.models import fastcluster, pipeline
        import inspect
        grid = inspect.signature(fastcluster.update_slice).parameters["grid_cells"].default
        if grid != cfg["fastcluster"]["grid_cells"]:
            raise ValueError(f"the program seeds from {grid} grid cells, the "
                             f"configuration states {cfg['fastcluster']['grid_cells']}")
        self.cfg, self.device = cfg, device
        self.ecfg = engine_config(cfg, GROUPS)
        q, n = self.ecfg.efast.micro_slices, cfg["slicing"]["n_events"]
        if q != cfg["efast"]["micro_slices"]:
            raise ValueError(f"the program runs q={q}, the configuration states "
                             f"{cfg['efast']['micro_slices']}")
        if q > 1 and (n % q or not self.ecfg.efast.max_candidates):
            raise ValueError(f"q={q} with {n}-event slices and a candidate cap of "
                             f"{self.ecfg.efast.max_candidates} takes the program's q=1 path")
        self.pipeline, self.fastcluster = pipeline, fastcluster

    def init(self):
        cl = self.fastcluster.init_state(self.ecfg.cluster,
                                         window_slices=self.cfg["fastcluster"]["window_slices"],
                                         device=self.device)
        return cl, self.pipeline.init_corner_state(self.ecfg, device=self.device)

    def step(self, state, x, y, t, valid):
        return self.pipeline.full_scan(state[0], state[1], x, y, t, valid, self.ecfg)

    def host(self, out):
        cl, co = out
        leaves = {f: getattr(cl, f) for f in CLUSTER_OUT}
        leaves.update({f: getattr(co, f) for f in CORNER_OUT})
        leaves.update({f"groups_{f}": getattr(co.groups, f) for f in GROUP_OUT})
        return to_host(leaves)

    def snapshot(self, state):
        return clone(state)


class Reference:
    def __init__(self, cfg: dict, device: torch.device, fdtype=torch.float32):
        self.cfg, self.device, self.fdtype = cfg, device, fdtype

    def init(self):
        return (ref_track.init_fast(self.cfg, self.device, self.fdtype),
                ref_track.init_corner(self.cfg, self.device, self.fdtype))

    def adopt(self, snap):
        """Either side's state as this reference's own, field by field."""
        own = self.init()

        def conv(mine, theirs):
            if isinstance(mine, tuple):
                return type(mine)(*[conv(m, getattr(theirs, f))
                                    for m, f in zip(mine, mine._fields)])
            return theirs.to(device=mine.device, dtype=mine.dtype).clone()

        return (conv(own[0], snap[0]),
                ref_track.CornerState(sae=conv(own[1].sae, snap[1].sae),
                                      tracks=conv(own[1].tracks, snap[1].tracks),
                                      slice_idx=conv(own[1].slice_idx, snap[1].slice_idx)))

    def step(self, state, x, y, t, valid, counts=None):
        cl, co = state
        outs = []
        for s in range(x.shape[0]):
            xs, ys, ts, vs = (torch.as_tensor(a[s], device=self.device) for a in (x, y, t, valid))
            cl, a = ref_track.cluster_step(cl, xs, ys, vs, self.cfg, counts)
            co, b = ref_track.corner_step(co, xs, ys, ts, vs, self.cfg, counts)
            outs.append({**a, **b})
        return (cl, co), {f: torch.stack([o[f] for o in outs]) for f in outs[0]}

    def host(self, out):
        return to_host(out)

    def snapshot(self, state):
        return clone(state)


def program(cfg: dict, device: torch.device):
    return Program(cfg, device)


def reference(cfg: dict, device: torch.device, control: bool = False):
    """The reference; with `control`, its cluster chain and tracker in
    bfloat16, the precision below the float32 the configuration states."""
    return Reference(cfg, device, torch.bfloat16 if control else torch.float32)


def prepare() -> None:
    """Settings the reference needs on the card: no TF32 in its matmuls."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

