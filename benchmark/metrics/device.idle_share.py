"""Per cent of the traced window in which no operation ran on the device:
1 - (the union of the device operations' intervals / the window), the
window being whole blocks (whole chunks of steps) of the traced run."""

from benchmark import trace


def read(ctx):
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s(ctx.trace) / ctx.trace.window_s)
