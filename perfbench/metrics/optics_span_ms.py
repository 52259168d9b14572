"""Host time in the `optics` spans per slice, ms: app B's OPTICS of one
slice, the exact count and the table, its copy to the host and the host
sweep, the split and the statistics (`models/optics.py:optics_slice`)
(layer: optics)."""

from perfbench import program_spans


def read(ctx):
    return program_spans.ms_per_slice(ctx.trace, "optics")
