"""The reference equals the port's CPU path (its plain versions) on small
slices of each configuration, from the stream's start and from a state
handed over mid-stream; the track configuration at its own q = 8 sub-slices,
on blobs and on the textured scene that binds the candidate cap."""

import numpy as np
import pytest
import torch

from conftest import small_cell
from perfbench import loops

CPU = torch.device("cpu")


@pytest.mark.parametrize("name", ["q8_blobs_replay", "q8_textured_live",
                                  "exact_textured_live"])
def test_reference_equals_the_port_on_cpu(name):
    cell = small_cell(name)
    if "efast" in cell.config:
        assert cell.config["efast"]["micro_slices"] == 8
    path = cell.path_module()
    prog = path.program(cell.config, CPU)
    ref = path.reference(cell.config, CPU)
    rec = loops.Recording(cell, 3, CPU)
    p_state, r_state = prog.init(), ref.init()
    p_outs, r_outs = [], []
    for g in range(6):
        if g == 3:   # hand the program's state over, as the check does mid-window
            r_state = ref.adopt(prog.snapshot(p_state))
        p_state, p_out = prog.step(p_state, *rec.to_device(g, 1))
        r_state, r_out = ref.step(r_state, *(a[None] for a in rec.host(g)))
        p_outs.append(prog.host(p_out))
        r_outs.append(ref.host(r_out))
    p = {f: np.concatenate([o[f] for o in p_outs]) for f in p_outs[0]}
    r = {f: np.concatenate([o[f] for o in r_outs]) for f in r_outs[0]}
    assert set(p) == set(r)
    nums = path.numbers(p, r)
    assert set(nums) == set(cell.limits) and not any(nums.values()), nums
    assert r["n"].sum() > 0, "clusters formed"
    if name == "q8_textured_live":
        assert r["num_dropped"].sum() > 0 and r["num_corners"].sum() > 0, "the cap binds"
