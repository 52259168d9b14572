"""Host time in the `candidates` spans per slice, ms: one representative
lane per touched pixel, sorted and compacted to the cap, per sub-slice at
q > 1 (`models/pipeline.py:_representative_candidates`) (layer:
candidates)."""

from perfbench import program_spans


def read(ctx):
    return program_spans.ms_per_slice(ctx.trace, "candidates")
