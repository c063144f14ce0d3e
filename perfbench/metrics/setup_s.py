"""setup_s: seconds from the start of the process to the start of the
window: imports, the kernels' library, the inputs, the fit's first steps
and the warm-up."""


def read(ctx):
    if ctx.trace is not None:
        return None
    return ctx.setup_s
