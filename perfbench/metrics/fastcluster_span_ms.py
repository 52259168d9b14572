"""Host time in the `fastcluster` spans per slice, ms: assignment (kernel
`assign_manhattan`), statistics (kernel `cluster_stats`), seeding, merge
and flow (`models/fastcluster.py`) (layer: clustering)."""

from perfbench import program_spans


def read(ctx):
    return program_spans.ms_per_slice(ctx.trace, "fastcluster")
