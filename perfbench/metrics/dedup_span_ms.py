"""Host time in the `dedup` spans per slice, ms: the hash dedup of the
cluster chain (`ops/hash_dedup.py:dedup_mask`), and on the exact path the
engine's whole input, dedup and lane compaction (`exact_engine_lanes`)
(layer: dedup)."""

from perfbench import program_spans


def read(ctx):
    return program_spans.ms_per_slice(ctx.trace, "dedup")
