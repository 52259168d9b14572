"""Host time in the `efast` spans per slice, ms: the corner test of the
candidates against the surface, the ring gather per sub-slice at q > 1
(`ops/efast.py`) (layer: eFAST)."""

from perfbench import program_spans


def read(ctx):
    return program_spans.ms_per_slice(ctx.trace, "efast")
