"""Host time in the `nms` spans per slice, ms: the corners' stream-order
compaction and the greedy suppression fixpoint with its rounds' syncs
(`ops/nms.py`) (layer: NMS)."""

from perfbench import program_spans


def read(ctx):
    return program_spans.ms_per_slice(ctx.trace, "nms")
