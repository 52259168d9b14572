"""Host time in the `tracker` spans per slice, ms: prediction, the
association and group-seed fixpoints with their rounds' syncs, spawn,
prune and groups (`models/tracker.py:update`) (layer: tracker)."""

from perfbench import program_spans


def read(ctx):
    return program_spans.ms_per_slice(ctx.trace, "tracker")
