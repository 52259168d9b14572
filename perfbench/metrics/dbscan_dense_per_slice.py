"""Share of slices whose DBSCAN takes the dense (block, N) panels: the
`dbscan.dense` spans per slice, one for each slice where the grid's table
does not apply or a neighbourhood overflows it
(`models/dbscan.py:_grid_or_dense`); 0 where every traced slice took the
grid (layer: dbscan)."""

from perfbench import program_spans


def read(ctx):
    if program_spans.count_per_slice(ctx.trace, "dbscan") is None:
        return None
    return program_spans.count_per_slice(ctx.trace, "dbscan.dense") or 0.0
