"""The profiler's trace of a few steps, reduced to what the per-layer
metrics read: the device operations (kernels, copies, memsets) with their
times, the card's busy time (the union of their intervals, as the port's
``profiling.DeviceProfile`` computes it, of which this is a copy), and the
host operation under each idle gap of the card."""

from __future__ import annotations

import bisect
import collections
import json
import os
import re
import tempfile
import time
from pathlib import Path
from typing import List, NamedTuple, Tuple

import torch

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cpu_op", "user_annotation")


class Trace(NamedTuple):
    device: List[Tuple[float, float, str]]  # (start µs, duration µs, name), in start order
    host: List[Tuple[float, float, str]]  # host operations and the benchmark's spans, in start order
    busy_us: float  # union of the device operations' intervals
    steps: int
    window_s: float  # host clock over the traced steps


def busy_union(device) -> float:
    total, end = 0.0, float("-inf")
    for start, dur, _ in device:
        total += dur - min(dur, max(0.0, end - start))  # its duration less its overlap with the earlier ones
        end = max(end, start + dur)
    return total


def read_chrome_trace(path: str):
    """(device events, host events) of an exported Chrome trace."""
    with open(path) as fh:
        data = json.load(fh)
    device, host = [], []
    for e in data.get("traceEvents", []):
        if e.get("ph") != "X" or "dur" not in e:
            continue
        item = (float(e["ts"]), float(e["dur"]), e["name"])
        if e.get("cat") in DEVICE_CATEGORIES:
            device.append(item)
        elif e.get("cat") in HOST_CATEGORIES:
            host.append(item)
    device.sort()
    host.sort()
    return device, host


def profile_steps(step, n_steps: int, sync) -> Trace:
    """Run ``step`` ``n_steps`` times under ``torch.profiler`` and read the
    trace back (written under the process's temporary directory, then
    deleted)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with tempfile.TemporaryDirectory(prefix="perfbench_trace_") as tmp:
        with profile(activities=activities) as prof:
            sync()
            t0 = time.perf_counter()
            for _ in range(n_steps):
                step()
            sync()
            window_s = time.perf_counter() - t0
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        device, host = read_chrome_trace(path)
    return Trace(device, host, busy_union(device), n_steps, window_s)


def kernel_patterns(root: Path) -> dict:
    """name → compiled pattern of every ``perfbench/kernels/<name>.json``."""
    out = {}
    for f in sorted((root / "perfbench" / "kernels").glob("*.json")):
        spec = json.loads(f.read_text())
        out[f.stem] = re.compile(spec["symbol_pattern"])
    return out


def kernel_events(trace: Trace, patterns: dict):
    """The device operations that a hand kernel's pattern names."""
    return [e for e in trace.device if any(p.search(e[2]) for p in patterns.values())]


def top_device_ops(trace: Trace, n: int = 10):
    total = collections.Counter()
    for _, dur, name in trace.device:
        total[name] += dur * 1e-6
    return [[name, s] for name, s in total.most_common(n)]


def idle_gaps(trace: Trace, n: int = 10):
    """The card's idle time between its operations, summed by the host
    event running at each gap's middle (the innermost operation, or the
    benchmark's span where no operation runs; "no_host_operation" where
    neither does), the largest ``n``."""
    starts = [h[0] for h in trace.host]
    total = collections.Counter()
    end = None
    for start, dur, _ in trace.device:
        if end is not None and start > end:
            mid = 0.5 * (start + end)
            total[_host_at(trace.host, starts, mid)] += (start - end) * 1e-6
        end = start + dur if end is None else max(end, start + dur)
    return [[name, s] for name, s in total.most_common(n)]


def _host_at(host, starts, t, reach: int = 20000):
    """The host event covering time ``t`` that started last (the innermost)."""
    last = bisect.bisect_right(starts, t) - 1
    for i in range(last, max(-1, last - reach), -1):
        start, dur, name = host[i]
        if start + dur >= t:
            return name
    return "no_host_operation"
