"""Checkpoint/resume through the port (the counterpart of
tests/test_checkpoint_resume.py), and checkpoints that cross between the
packages.

A stream split across a save/restore boundary gives bit-identical outputs
to an unbroken run: for both pipelines at the Python API and for the CLI's
--checkpoint/--resume. The npz format is the JAX package's, key for key,
so a checkpoint saved by either package resumes in the other, and the
resumed run is bit-identical to the unbroken run. The exact path agrees
with JAX bit for bit, so its resumed half equals the other package's
unbroken run. The fast cluster path's floats agree with JAX within f32
reduction order, and the tracker's within an ulp or so, so their resumed
half is held to the unbroken run of the resuming package from the first
half's state carried over in memory (interop), which the restored state
also equals bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

from evflow_tpu.models import pipeline as jp
from evflow_tpu.utils import checkpoint as jckpt
from evflow_tpu_torch import interop
from evflow_tpu_torch.config import ClusterConfig, EngineConfig, SliceConfig
from evflow_tpu_torch.io import save_csv, synthetic
from evflow_tpu_torch.models import pipeline
from evflow_tpu_torch.utils import checkpoint as ckpt

N = 2048
CFG = EngineConfig(slicing=SliceConfig(n_events=N, mode="n_events"),
                   cluster=ClusterConfig(radius=40.0, min_n=10, max_clusters=64))
EXACT_CFG = dataclasses.replace(CFG, cluster=dataclasses.replace(
    CFG.cluster, sz_buffer=400, max_members=1024))
EXACT = dict(rtol=0, atol=0)


def _stream(num_slices=6):
    return synthetic.moving_blob_stream(
        num_slices=num_slices, events_per_slice=N,
        blob_centers=((300.0, 300.0), (800.0, 400.0)),
        velocities=((20.0, 0.0), (0.0, 15.0)), sigma=10.0)


def _assert_outputs_equal(a, b):
    assert len(a) == len(b)
    for s, (oa, ob) in enumerate(zip(a, b)):
        interop.assert_trees_close(oa, ob, **EXACT, what=f"slice {s}")


def test_cluster_flow_split_resume_bit_identical(tmp_path):
    stream = _stream(6)
    full = pipeline.ClusterFlowPipeline(CFG, device="cpu").run(stream)

    cut = 3 * N
    pipe1 = pipeline.ClusterFlowPipeline(CFG, device="cpu")
    first = pipe1.run(stream[:cut])
    path = str(tmp_path / "cluster.npz")
    ckpt.save_npz(path, pipe1.final_state)

    pipe2 = pipeline.ClusterFlowPipeline(CFG, device="cpu")
    restored = ckpt.restore_npz(path, pipe2.init_state())
    second = pipe2.run(stream[cut:], state=restored)
    _assert_outputs_equal(first + second, full)


def test_corner_track_split_resume_bit_identical(tmp_path):
    stream = synthetic.moving_edge_stream(num_slices=6, events_per_slice=N)
    full = pipeline.CornerTrackPipeline(CFG, device="cpu").run(stream)
    assert any(int(o.num_corners) > 0 for o in full[1:])

    cut = 3 * N
    pipe1 = pipeline.CornerTrackPipeline(CFG, device="cpu")
    first = pipe1.run(stream[:cut])
    path = str(tmp_path / "corner.npz")
    ckpt.save_npz(path, pipe1.final_state, meta={"t0": pipe1.t0})

    pipe2 = pipeline.CornerTrackPipeline(CFG, device="cpu")
    restored = ckpt.restore_npz(path, pipeline.init_corner_state(CFG, device="cpu"))
    second = pipe2.run(stream[cut:], state=restored, t0=int(ckpt.load_meta(path)["t0"]))
    _assert_outputs_equal(first + second, full)


def _slice_blocks(out):
    """Per-slice report blocks, slice index stripped (resume renumbers)."""
    blocks, cur = [], None
    for line in out.splitlines():
        if line.startswith("slice "):
            if cur is not None:
                blocks.append(cur)
            cur = [line.split(":", 1)[1]]
        elif line.startswith("  ") and cur is not None:
            cur.append(line)
    if cur is not None:
        blocks.append(cur)
    return blocks


@pytest.mark.parametrize("extra", [[], ["--exact"]], ids=["fast", "exact"])
def test_cli_checkpoint_resume_bit_identical(tmp_path, capsys, extra):
    """The CLI runs DEFAULT (16384-event slices); the split is on a slice
    boundary, so the unbroken and the split runs report the same tables."""
    from evflow_tpu_torch.run import main
    n = 16384
    stream = synthetic.moving_blob_stream(
        num_slices=4, events_per_slice=n,
        blob_centers=((300.0, 300.0), (800.0, 400.0)),
        velocities=((20.0, 0.0), (0.0, 15.0)), sigma=10.0)
    cut = 2 * n
    paths = {k: str(tmp_path / f"{k}.csv") for k in ("full", "a", "b")}
    save_csv(stream, paths["full"])
    save_csv(stream[:cut], paths["a"])
    save_csv(stream[cut:], paths["b"])
    ck = str(tmp_path / "state.npz")
    cpu = ["--device", "cpu"]

    main(["cluster-flow", "--input", paths["full"]] + extra + cpu)
    full_blocks = _slice_blocks(capsys.readouterr().out)
    main(["cluster-flow", "--input", paths["a"], "--checkpoint", ck] + extra + cpu)
    a_out = capsys.readouterr().out
    assert "checkpoint saved" in a_out
    main(["cluster-flow", "--input", paths["b"], "--resume", ck] + extra + cpu)
    b_blocks = _slice_blocks(capsys.readouterr().out)
    assert len(full_blocks) == 4
    assert _slice_blocks(a_out) + b_blocks == full_blocks


def test_cli_exact_resume_without_t0_meta_exits(tmp_path, capsys):
    from evflow_tpu_torch.config import DEFAULT
    from evflow_tpu_torch.run import main
    csv, ck = str(tmp_path / "s.csv"), str(tmp_path / "state.npz")
    save_csv(_stream(1), csv)
    # an exact-mode state saved through the library, without the t0 meta
    ckpt.save_npz(ck, pipeline.ClusterFlowPipeline(DEFAULT, mode="exact",
                                                   device="cpu").init_state())
    with pytest.raises(SystemExit) as e:
        main(["cluster-flow", "--input", csv, "--resume", ck, "--exact", "--device", "cpu"])
    assert "missing t0 meta" in str(e.value.code)


# ------------------------------------------- across the packages

def _pipes(kind):
    """(JAX pipeline, port pipeline, JAX template, port template) factories
    of one pipeline kind."""
    if kind == "corner":
        return (lambda: jp.CornerTrackPipeline(CFG),
                lambda: pipeline.CornerTrackPipeline(CFG, device="cpu"),
                lambda: jp.init_corner_state(CFG),
                lambda: pipeline.init_corner_state(CFG, device="cpu"))
    cfg, mode = (EXACT_CFG, "exact") if kind == "exact" else (CFG, "fast")
    return (lambda: jp.ClusterFlowPipeline(cfg, mode=mode),
            lambda: pipeline.ClusterFlowPipeline(cfg, mode=mode, device="cpu"),
            lambda: jp.ClusterFlowPipeline(cfg, mode=mode).init_state(),
            lambda: pipeline.ClusterFlowPipeline(cfg, mode=mode, device="cpu").init_state())


def _kind_stream(kind):
    if kind == "corner":
        return synthetic.moving_edge_stream(num_slices=6, events_per_slice=N)
    return _stream(6)


def _t0_meta(pipe, kind):
    return None if kind == "fast" else {"t0": pipe.t0}


def _resume(pipe, stream, state, path, kind):
    t0 = None if kind == "fast" else int(np.asarray(jckpt.load_meta(path)["t0"]))
    return pipe.run(stream, state=state, t0=t0)


@pytest.mark.parametrize("kind", ["fast", "exact", "corner"])
def test_jax_checkpoint_resumes_in_the_port(kind, tmp_path):
    jpipe, ppipe, _, ptemplate = _pipes(kind)
    stream, cut = _kind_stream(kind), 3 * N
    head = jpipe()
    head.run(stream[:cut])
    path = str(tmp_path / "jax.npz")
    jckpt.save_npz(path, head.final_state, meta=_t0_meta(head, kind))

    restored = ckpt.restore_npz(path, ptemplate())
    interop.assert_trees_close(restored, interop.from_jax(ptemplate(), head.final_state),
                               **EXACT, what="restored state")
    got = _resume(ppipe(), stream[cut:], restored, path, kind)
    if kind != "exact":
        # the unbroken run: the port continuing from the JAX state in memory
        want = ppipe().run(stream[cut:], state=interop.from_jax(ptemplate(), head.final_state),
                           t0=None if kind == "fast" else head.t0)
    else:
        want = jpipe().run(stream)[3:]
    assert len(got) == 3
    _assert_outputs_equal(got, want)


@pytest.mark.parametrize("kind", ["fast", "exact", "corner"])
def test_port_checkpoint_resumes_in_jax(kind, tmp_path):
    jpipe, ppipe, jtemplate, _ = _pipes(kind)
    stream, cut = _kind_stream(kind), 3 * N
    head = ppipe()
    head.run(stream[:cut])
    path = str(tmp_path / "port.npz")
    ckpt.save_npz(path, head.final_state, meta=_t0_meta(head, kind))

    restored = jckpt.restore_npz(path, jtemplate())
    got = _resume(jpipe(), stream[cut:], restored, path, kind)
    if kind != "exact":
        # the unbroken run: JAX continuing from the port's state in memory
        import jax
        treedef = jax.tree_util.tree_structure(jtemplate())
        handed = jax.tree_util.tree_unflatten(treedef, interop.to_leaves(head.final_state))
        want = jpipe().run(stream[cut:], state=handed, t0=None if kind == "fast" else head.t0)
    else:
        want = ppipe().run(stream)[3:]
    assert len(got) == 3
    _assert_outputs_equal(got, want)


def test_torch_save_round_trip(tmp_path):
    pipe = pipeline.CornerTrackPipeline(CFG, device="cpu")
    pipe.run(synthetic.moving_edge_stream(num_slices=2, events_per_slice=N))
    path = str(tmp_path / "corner.pt")
    ckpt.save_torch(path, pipe.final_state)
    back = ckpt.restore_torch(path, pipeline.init_corner_state(CFG, device="cpu"))
    interop.assert_trees_close(back, pipe.final_state, **EXACT)
