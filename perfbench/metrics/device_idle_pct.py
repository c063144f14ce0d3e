"""device_idle_pct: the share of the traced window in which no device
operation ran, in % (busy time = the union of the operations' intervals)."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.device or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_us * 1e-6 / ctx.trace.window_s)
