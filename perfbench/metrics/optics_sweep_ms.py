"""Host time in the `optics.sweep` spans per slice, ms: the table's copy
to the host, which waits for the table, and the native sweep
(`models/optics.py:optics_slice`, `native/optics_sweep.cpp`) (layer:
optics)."""

from perfbench import program_spans


def read(ctx):
    return program_spans.ms_per_slice(ctx.trace, "optics.sweep")
