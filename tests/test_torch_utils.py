"""The port's utils against tests/test_utils.py's cases: the npz
checkpoint round trip and its shape check, the span API (`span`,
`spanned`) and the Chrome trace, and the PCD reader and writer
(plus files byte-equal to the JAX package's writer's)."""

import json
import os

import numpy as np
import pytest
import torch

from evflow_tpu.utils import pcd as jpcd
from evflow_tpu_torch.config import ClusterConfig
from evflow_tpu_torch.models import fastcluster
from evflow_tpu_torch.utils import checkpoint, pcd, profiling


def test_checkpoint_roundtrip_fastcluster(tmp_path):
    cfg = ClusterConfig(max_clusters=8)
    st = fastcluster.init_state(cfg, device="cpu")
    st = st._replace(next_cid=torch.tensor(5, dtype=torch.int32),
                     alive=st.alive.clone().index_fill_(0, torch.tensor([2]), True))
    p = str(tmp_path / "ck.npz")
    checkpoint.save_npz(p, st)
    back = checkpoint.restore_npz(p, fastcluster.init_state(cfg, device="cpu"))
    assert int(back.next_cid) == 5
    assert bool(back.alive[2])
    for a, b in zip(back, st):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_shape_mismatch_rejected(tmp_path):
    st = fastcluster.init_state(ClusterConfig(max_clusters=8), device="cpu")
    p = str(tmp_path / "ck.npz")
    checkpoint.save_npz(p, st)
    with pytest.raises(AssertionError):
        checkpoint.restore_npz(p, fastcluster.init_state(ClusterConfig(max_clusters=16),
                                                         device="cpu"))


def test_span_and_trace(tmp_path):
    """Inside `trace`, each span is a range of the Chrome trace; outside any
    profiler, `span` is one shared no-op context."""
    log_dir = str(tmp_path / "trace")
    with profiling.trace(log_dir):
        for _ in range(2):
            with profiling.span("dedup"):
                torch.arange(1000).sort()
    with open(os.path.join(log_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert sum(e.get("name") == "dedup" and e.get("cat") == "user_annotation"
               for e in events) == 2
    assert profiling.span("dedup") is profiling.span("tracker")

    @profiling.spanned("sae")
    def scatter(n):
        return torch.arange(n).flip(0)

    with profiling.trace(log_dir):
        assert scatter(4).tolist() == [3, 2, 1, 0]
    with open(os.path.join(log_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert sum(e.get("name") == "sae" and e.get("cat") == "user_annotation"
               for e in events) == 1


def test_pcd_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    pts = rng.random((50, 3)).astype(np.float32)
    inten = (np.arange(50) % 8).astype(np.float32)
    for binary in (False, True):
        p = str(tmp_path / f"c{binary}.pcd")
        pcd.save_pcd(p, pts, inten, binary=binary)
        back, bint = pcd.load_pcd(p)
        np.testing.assert_allclose(back, pts, atol=1e-5)
        np.testing.assert_allclose(bint, inten, atol=1e-5)
        q = str(tmp_path / f"j{binary}.pcd")
        jpcd.save_pcd(q, pts, inten, binary=binary)
        assert open(p, "rb").read() == open(q, "rb").read()
    p = str(tmp_path / "n.pcd")
    pcd.save_pcd(p, pts)
    back, bint = pcd.load_pcd(p)
    assert bint is None
    np.testing.assert_allclose(back, pts, atol=1e-5)
