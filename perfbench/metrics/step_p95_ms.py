"""step_p95_ms: the 95th percentile (nearest rank) of the window's step
times, in ms. Each step is timed by CUDA events on the card, from its first
launch to its last operation: a single ~180 ms step is too short for the
host clock's half-millisecond error."""

import math


def read(ctx):
    times = sorted(ctx.step_seconds)
    if ctx.trace is not None or not times:
        return None
    return times[math.ceil(0.95 * len(times)) - 1] * 1e3
