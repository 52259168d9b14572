"""Rounds of DBSCAN's label propagation per slice: `dbscan.round` spans,
one host sync each (`models/dbscan.py:_propagate`) (layer: dbscan)."""

from perfbench import program_spans


def read(ctx):
    return program_spans.count_per_slice(ctx.trace, "dbscan.round")
