"""step_ms: the measured window's host-clock time over the steps it ran, in
ms (every step and every re-plan of the window counted)."""


def read(ctx):
    if ctx.trace is not None or not ctx.n_steps:
        return None
    return ctx.window_s / ctx.n_steps * 1e3
