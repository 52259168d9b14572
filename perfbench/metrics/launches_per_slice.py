"""Kernel launches per slice, the hand-written kernels' and PyTorch's alike:
the launch calls of the CUDA runtime and driver inside the harness's
`step_call` spans (layer: driver, `models/pipeline.py`). The harness's own
copies and time shift lie outside those spans."""


def read(ctx):
    if not ctx.trace.runtime or not ctx.stretch_slices:
        return None
    return len(ctx.trace.in_spans(ctx.trace.launches(), "step_call")) / ctx.stretch_slices
