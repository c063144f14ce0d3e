"""glue_ms: device-busy ms a step outside the hand kernels: the planner's
statistics, binning, tables, gathers, autograd's and Adam's operations."""

from perfbench.trace import kernel_events, kernel_patterns


def read(ctx):
    if ctx.trace is None or not ctx.trace.device:
        return None
    kernel_us = sum(dur for _, dur, _ in kernel_events(ctx.trace, kernel_patterns(ctx.root)))
    return (ctx.trace.busy_us - kernel_us) * 1e-3 / ctx.trace.steps
