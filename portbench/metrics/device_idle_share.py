"""device_idle_share.train / .score: the share of the traced window's wall
time in which no operation ran on the card, 1 - (union of the device's
busy intervals) / (window), in %."""


def read(ctx):
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s)
