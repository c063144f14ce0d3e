"""peak_mem_gib: torch.cuda.max_memory_allocated over the window, in GiB."""


def read(ctx):
    if ctx.trace is not None or not ctx.window_peak_bytes:
        return None
    return ctx.window_peak_bytes / 2**30
