"""Host time in the `dbscan` spans per slice, ms: app C's DBSCAN of one
slice, the grid attempt, the dense fallback with its propagation rounds'
syncs, and the sizes and centroids (`models/dbscan.py:dbscan_slice`)
(layer: dbscan)."""

from perfbench import program_spans


def read(ctx):
    return program_spans.ms_per_slice(ctx.trace, "dbscan")
