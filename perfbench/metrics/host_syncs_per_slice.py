"""Synchronizing runtime calls per slice inside the harness's `step_call`
spans: stream, event and device synchronizations and blocking copies, the
host waiting on the card (layer: fixpoints and driver, `ops/nms.py`,
`models/tracker.py`, `models/pipeline.py`). The harness's own output copies
lie in its `outputs_out` spans and are not counted."""


def read(ctx):
    if not ctx.trace.runtime or not ctx.stretch_slices:
        return None
    return len(ctx.trace.in_spans(ctx.trace.syncs(), "step_call")) / ctx.stretch_slices
