"""Rounds of the tracker's association fixpoint per slice:
`tracker.associate.round` spans, one host sync each
(`models/tracker.py:_associate`) (layer: fixpoints and driver)."""

from perfbench import program_spans


def read(ctx):
    return program_spans.count_per_slice(ctx.trace, "tracker.associate.round")
