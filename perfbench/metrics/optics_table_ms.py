"""Host time in the `optics.table` spans per slice, ms: the exact
neighbour count with the read-back that sizes K, the table builders'
decision and the table (`models/optics.py:optics_slice`) (layer: optics)."""

from perfbench import program_spans


def read(ctx):
    return program_spans.ms_per_slice(ctx.trace, "optics.table")
