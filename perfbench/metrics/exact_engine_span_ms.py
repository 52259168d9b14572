"""Host time in the `exact_engine` spans per slice, ms: the exact engine's
call (kernel `aeclustering_exact`) and its snapshot
(`models/pipeline.py:cluster_flow_step_exact`); beside the kernel's
roofline it separates the engine's host cost from its device time
(layer: exact engine)."""

from perfbench import program_spans


def read(ctx):
    return program_spans.ms_per_slice(ctx.trace, "exact_engine")
