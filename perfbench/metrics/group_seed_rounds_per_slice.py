"""Rounds of the tracker's group-seed fixpoint per slice:
`tracker.group_seeds.round` spans, one host sync each
(`models/tracker.py:_group_seeds`) (layer: fixpoints and driver)."""

from perfbench import program_spans


def read(ctx):
    return program_spans.count_per_slice(ctx.trace, "tracker.group_seeds.round")
