"""Self time of the `slice` spans per slice, ms: each slice's host time
outside every module's span, the driver's own per-slice work such as the
exact path's cid flow or the concatenation of sub-slice candidates
(`models/pipeline.py`) (layer: driver)."""

from perfbench import program_spans


def read(ctx):
    return program_spans.slice_self_ms(ctx.trace)
