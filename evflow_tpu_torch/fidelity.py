"""Corner fidelity of the micro-slice detector (counterpart of bench.py's
`measure_agreement`).

On a scene of a repainted wedge drifting right (8 slices of 2048 events,
128x128 sensor), the share of per-event-exact corner pixels (the reference's
detect-against-the-evolving-surface semantics) that the q-micro-slice
detector finds within one NMS box. The JAX package's values on this scene
are `JAX_AGREEMENT` (bench.py:measure_agreement on the CPU, where its
arithmetic is exact: integer times, no float in the decision);
tests/test_torch_exact_pipeline.py runs that function and holds both the
constants and this module's values to it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config import EngineConfig, NMSConfig, SensorConfig, SliceConfig

from .models import pipeline
from .ops import efast, sae as sae_ops

JAX_AGREEMENT = {8: 0.9393939393939394, 1: 0.696969696969697}


def wedge(cx: int, cy: int, t0: int, n: int = 2048, seed: int = 0):
    """n events filling the 41x41 wedge with apex (cx, cy), times sorted."""
    rng = np.random.default_rng(seed)
    x = rng.integers(max(0, cx - 40), cx + 1, n).astype(np.int32)
    y = rng.integers(max(0, cy - 40), cy + 1, n).astype(np.int32)
    t = (t0 + np.sort(rng.integers(0, 900, n))).astype(np.int32)
    return x, y, t


def corner_agreement(q: int, device="cuda", stack: bool = False) -> float:
    """Within-one-NMS-box agreement of the q-micro-slice detector's corner
    pixels with the per-event-exact ones, over slices 1-7 of the scene;
    with `stack`, of the snapshot-stack detector (`micro_stack=True`)."""
    cfg = EngineConfig(sensor=SensorConfig(width=128, height=128),
                       slicing=SliceConfig(n_events=2048),
                       nms=NMSConfig(max_corners=64))
    cfgq = dataclasses.replace(
        cfg, efast=dataclasses.replace(cfg.efast, micro_slices=q,
                                       max_candidates=2048, micro_stack=stack))
    exact, got = [], []
    sae_e = sae_ops.init_sae(cfg.sensor, device=device)
    sae_q = sae_ops.init_sae(cfg.sensor, device=device)
    cx, cy = 50, 50
    for s in range(8):
        x, y, t = wedge(cx, cy, 1000 * (s + 1), seed=s)
        xv, yv, tv = (torch.as_tensor(a, device=device) for a in (x, y, t))
        ones = torch.ones(len(x), dtype=torch.bool, device=device)
        sae_e, m = pipeline.event_exact_corner_mask(sae_e, xv, yv, tv, ones, s > 0, cfg)
        m = m.cpu().numpy()
        exact.append({(int(a), int(b)) for a, b in zip(x[m], y[m])})
        if stack:
            sae_q, scx, scy, mk, _ = pipeline.stack_detect(sae_q, xv, yv, tv, ones, cfgq)
            found = [(scx, scy, mk)]
        else:
            found = []
            nsub = len(x) // q
            for k in range(q):
                sl = slice(k * nsub, (k + 1) * nsub)
                sae_q = sae_ops.update_sae(sae_q, xv[sl], yv[sl], tv[sl], ones[sl])
                scx, scy, scv, _ = (a[0] for a in pipeline.representative_candidates(
                    xv[None, sl], yv[None, sl], ones[None, sl], 2048 // q, cfgq))
                found.append((scx, scy, efast.detect_corners(sae_q, scx, scy, scv,
                                                             cfgq.efast, cfgq.sensor)))
        pix = set()
        for scx, scy, mk in found if s > 0 else ():
            mk, sx, sy = mk.cpu().numpy(), scx.cpu().numpy(), scy.cpu().numpy()
            pix |= {(int(a), int(b)) for a, b in zip(sx[mk], sy[mk])}
        got.append(pix)
        cx += 6

    hits = tot = 0
    box = cfg.nms.box_size
    for e, g in zip(exact, got):
        ga = np.array(sorted(g), float).reshape(-1, 2)
        for p in e:
            tot += 1
            if len(ga) and np.abs(ga - np.array(p, float)).max(1).min() <= box:
                hits += 1
    return hits / max(tot, 1)
