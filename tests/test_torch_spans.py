"""The port's spans (`utils/profiling.span`) inside the program: under
`torch.profiler`, `full_scan` at q=8 writes every module's span and every
fixpoint round's span nested under a `slice` span, the exact scan writes
`slice`, `dedup` and `exact_engine`; with no profiler, no
`record_function` is entered. The round spans count the loops' rounds:
on built cases whose round count is known (a suppression chain for NMS,
contested detections for the association, a chain of group seeds), the
spans equal it. Small sensor and slices; moving wedges (eFAST corners)
and gaussian blobs (clusters)."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from evflow_tpu_torch.config import (DEFAULT, ClusterConfig, NMSConfig, SensorConfig,
                                     SliceConfig, TrackerConfig)
from evflow_tpu_torch.models import fastcluster, pipeline, tracker
from evflow_tpu_torch.ops import nms
from evflow_tpu_torch.utils import profiling

torch.set_num_threads(2)

N = 1024
CFG = dataclasses.replace(
    DEFAULT, sensor=SensorConfig(width=256, height=120),
    slicing=SliceConfig(n_events=N),
    efast=dataclasses.replace(DEFAULT.efast, max_candidates=512, micro_slices=8),
    nms=NMSConfig(max_corners=128), tracker=TrackerConfig(max_tracks=64),
    cluster=ClusterConfig(max_clusters=32))
EXACT_CFG = dataclasses.replace(
    CFG, cluster=ClusterConfig(sz_buffer=400, radius=20.0, min_n=5,
                               max_clusters=32, max_members=1024))
MODULE_SPANS = ("dedup", "fastcluster", "sae", "candidates", "efast", "nms", "tracker")
ROUND_SPANS = ("nms.round", "tracker.associate.round", "tracker.group_seeds.round")


def _slices(num_slices, seed=0):
    """(S, N) x, y, t, valid: three filled wedges painted pixel by pixel
    (their apexes are corners) drifting across, and two gaussian blobs."""
    rng = np.random.default_rng(seed)
    xs, ys, ts = [], [], []
    for s in range(num_slices):
        px, py = [], []
        for ax, ay in ((40 + 2 * s, 40), (150 + s, 90), (200 - s, 30)):
            gx, gy = np.meshgrid(np.arange(ax - 8, ax + 1), np.arange(ay - 8, ay + 1))
            px.append(gx.ravel())
            py.append(gy.ravel())
        rest = N - sum(len(p) for p in px)
        for (bx, by), nb in zip(((80 + 3 * s, 70), (190 - 2 * s, 60)),
                                (rest // 2, rest - rest // 2)):
            px.append(np.clip(rng.normal(bx, 4.0, nb), 0, 255))
            py.append(np.clip(rng.normal(by, 4.0, nb), 0, 119))
        x = np.concatenate(px).astype(np.int32)
        y = np.concatenate(py).astype(np.int32)
        perm = rng.permutation(N)
        xs.append(x[perm])
        ys.append(y[perm])
        ts.append(1000 * (s + 1) + np.sort(rng.integers(0, 900, N)))
    return (torch.as_tensor(np.stack(xs)), torch.as_tensor(np.stack(ys)),
            torch.as_tensor(np.stack(ts).astype(np.int32)),
            torch.ones(num_slices, N, dtype=torch.bool))


def _full_scan(num_slices=3):
    cl = fastcluster.init_state(CFG.cluster, device="cpu")
    co = pipeline.init_corner_state(CFG, device="cpu")
    return pipeline.full_scan(cl, co, *_slices(num_slices), CFG)


def _exact_scan(num_slices=2):
    state = pipeline.ClusterFlowPipeline(EXACT_CFG, mode="exact", device="cpu").init_state()
    return pipeline.cluster_flow_scan_exact(state, *_slices(num_slices), EXACT_CFG)


def _spans(tmp_path, fn):
    """The program's spans that `fn()` writes under torch.profiler, as
    (name, start, end) in µs, sorted by start."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return sorted((e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                  for e in events if e.get("cat") == "user_annotation"
                  and e.get("ph") == "X")


def _count(spans, name):
    return sum(s[0] == name for s in spans)


def _nested_under_slices(spans):
    slices = [(a, b) for n, a, b in spans if n == "slice"]
    return all(any(a <= s and e <= b for a, b in slices)
               for n, s, e in spans if n != "slice")


def test_full_scan_q8_spans(tmp_path):
    spans = _spans(tmp_path, lambda: _full_scan(3))
    assert _count(spans, "slice") == 3
    for name in MODULE_SPANS + ROUND_SPANS:
        assert _count(spans, name) >= 3, name
    # q=8: the SAE and eFAST of every sub-slice; the candidates of all 8
    # sub-slices in one call per slice
    for name in ("sae", "efast"):
        assert _count(spans, name) == 3 * 8, name
    assert _count(spans, "candidates") == 3
    assert _nested_under_slices(spans)


def test_exact_scan_spans(tmp_path):
    spans = _spans(tmp_path, lambda: _exact_scan(2))
    assert _count(spans, "slice") == 2
    assert _count(spans, "exact_engine") == 2
    assert _count(spans, "dedup") >= 2
    assert _nested_under_slices(spans)


def test_no_profiler_enters_no_record_function(monkeypatch):
    calls = []
    real = torch.profiler.record_function

    def counting(name, *args, **kwargs):
        calls.append(name)
        return real(name, *args, **kwargs)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    assert profiling.span("slice") is profiling.span("nms.round")
    _full_scan(2)
    _exact_scan(1)
    assert calls == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        _full_scan(1)
    assert calls.count("slice") == 1 and "nms.round" in calls


@pytest.mark.parametrize("k", [1, 2, 5, 9])
def test_nms_round_spans_count_the_rounds(tmp_path, k, monkeypatch):
    """A chain of k corners, each in the box of the one before and clear of
    the one two before: the accepted set alternates, and each round fixes
    one more corner of the chain, so the loop takes k rounds, the last one
    seeing no change (one corner: one round). Each round also checks
    convergence once, so the checks count the rounds too."""
    cfg = NMSConfig(box_size=15, max_corners=16)
    step = 2 * (cfg.box_size // 2)           # in the box of the one before
    x = torch.arange(k, dtype=torch.int32) * step + 20
    y = torch.full((k,), 30, dtype=torch.int32)
    checks = []
    real_equal = torch.equal
    monkeypatch.setattr(torch, "equal", lambda a, b: checks.append(1) or real_equal(a, b))
    out = {}
    spans = _spans(tmp_path, lambda: out.update(
        res=nms.accept_corners(x, y, torch.ones(k, dtype=torch.bool), cfg)))
    acc, count = out["res"]
    assert acc.tolist() == [i % 2 == 0 for i in range(k)]
    assert int(count) == (k + 1) // 2
    assert _count(spans, "nms.round") == k == len(checks)


@pytest.mark.parametrize("k", [1, 3, 6])
def test_associate_round_spans_count_the_rounds(tmp_path, k):
    """k eligible tracks at one place, all reaching the same k detections at
    distances 1..k: every round the earliest open track takes the nearest
    free detection and the others wait behind it (the reach rule), so k
    rounds commit one match each and round k + 1 commits none."""
    t = d = k
    dist = torch.arange(1, d + 1, dtype=torch.float32)[None, :].expand(t, d).contiguous()
    seq = torch.arange(t, dtype=torch.int32)
    out = {}
    spans = _spans(tmp_path, lambda: out.update(match=tracker._associate(
        dist, dist < 100.0, torch.ones(t, dtype=torch.bool), seq,
        torch.ones(d, dtype=torch.bool), 100.0)))
    assert out["match"].tolist() == list(range(k))
    assert _count(spans, "tracker.associate.round") == k + 1


@pytest.mark.parametrize("k", [1, 4, 7])
def test_group_seed_round_spans_count_the_rounds(tmp_path, k):
    """A chain of k detected tracks in seq order, each within the group
    radius of its neighbours only: seeds alternate, and as for NMS each
    round fixes one more track, k rounds in all."""
    idx = torch.arange(k)
    within = (idx[:, None] - idx[None, :]).abs() <= 1
    out = {}
    spans = _spans(tmp_path, lambda: out.update(seeds=tracker._group_seeds(
        torch.ones(k, dtype=torch.bool), within, idx.to(torch.int32))))
    assert out["seeds"].tolist() == [i % 2 == 0 for i in range(k)]
    assert _count(spans, "tracker.group_seeds.round") == k
