"""kernel_roofline_pct: the least time of a step's rasterization work
(``perfbench.roofline``: bytes and operations counted from the scene
alone) over the hand kernels' device time a step, in %."""

from perfbench.roofline import least_seconds, step_work
from perfbench.trace import kernel_events, kernel_patterns


def read(ctx):
    if ctx.trace is None or ctx.sizes is None:
        return None
    events = kernel_events(ctx.trace, kernel_patterns(ctx.root))
    least = least_seconds(step_work(ctx.sizes, ctx.itemsize), ctx.dtype, ctx.device_kind)
    if not events or least is None:
        return None
    kernel_s = sum(dur for _, dur, _ in events) * 1e-6 / ctx.trace.steps
    return 100.0 * least[0] / kernel_s
