"""`<kernel>_roofline`: the kernel's least time over its device time, both
summed over its launches in the traced stretch, in %. The least time of a
launch is `peaks.least_seconds` of the bytes and operations that
`kernels/<kernel>.py` counts for its slice, from the reference's counts on
the same slices (never the program's); launch i of the stretch is the
kernel's launch on the stretch's slice i. Nothing to read where the kernel
did not run or the reference covered none of its slices (layer: kernels)."""

from perfbench import peaks


def read(ctx):
    mod = ctx.kernel
    launches = [e for e in ctx.trace.device if mod.TRACE_NAME in e["name"]]
    n = min(len(launches), len(ctx.slice_counts))
    if n == 0:
        return None
    least = sum(peaks.least_seconds(*mod.work(ctx.slice_counts[i], ctx.config))
                for i in range(n))
    device = sum(float(e["dur"]) for e in launches[:n]) * 1e-6
    return 100.0 * least / device if device > 0 else None
