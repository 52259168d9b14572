"""Share of the traced stretch in which no kernel, copy or memset runs on
the card (layer: device)."""


def read(ctx):
    if not ctx.trace.device:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s)
