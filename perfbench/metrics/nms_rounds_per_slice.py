"""Rounds of the NMS fixpoint per slice: `nms.round` spans, one host sync
each (`ops/nms.py:accept_corners`) (layer: fixpoints and driver)."""

from perfbench import program_spans


def read(ctx):
    return program_spans.count_per_slice(ctx.trace, "nms.round")
