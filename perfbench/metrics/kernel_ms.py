"""kernel_ms: device ms a step of the operations that a
``perfbench/kernels/<name>.json`` pattern names (the hand kernels)."""

from perfbench.trace import kernel_events, kernel_patterns


def read(ctx):
    if ctx.trace is None:
        return None
    events = kernel_events(ctx.trace, kernel_patterns(ctx.root))
    if not events:
        return None
    return sum(dur for _, dur, _ in events) * 1e-3 / ctx.trace.steps
