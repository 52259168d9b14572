"""Host time in the `sae` spans per slice, ms: the time surface's
scatter-max, per sub-slice at q > 1 (`ops/sae.py:update_sae`) (layer:
SAE)."""

from perfbench import program_spans


def read(ctx):
    return program_spans.ms_per_slice(ctx.trace, "sae")
