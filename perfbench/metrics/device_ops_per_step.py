"""device_ops_per_step: device operations (kernels, copies, memsets) in the
profiler's trace, over the traced steps."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.device:
        return None
    return len(ctx.trace.device) / ctx.trace.steps
