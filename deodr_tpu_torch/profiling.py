"""Device-side profiling helpers.

PyTorch counterpart of ``deodr_tpu/profiling.py``: on the card the useful
observable is per-kernel *device* time (host wall clock includes the
Python dispatch of every operation). ``device_profile`` wraps
``torch.profiler`` with CUDA activity, exports its Chrome trace and digests
the device events (kernels, copies, memsets) into a per-name table.

Usage::

    from deodr_tpu_torch.profiling import device_profile

    with device_profile() as prof:
        out = step(params)
    print(prof.report(top=10))      # per-kernel device µs
    prof.times                      # {kernel name: total µs}

Only device events are kept, as in the JAX package: a run on the CPU gives
an empty table.
"""

from __future__ import annotations

import collections
import glob
import gzip
import json
import os
import shutil
import tempfile
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

# Chrome-trace categories of the operations that run on the card
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


class DeviceProfile:
    """Result of a :func:`device_profile` block: ``times`` and ``counts``
    per device operation name, ``total_us`` the card's busy time (the union
    of the operations' intervals), ``events`` the operations as (start µs,
    duration µs, name) in start order."""

    def __init__(self) -> None:
        self.times: Dict[str, float] = {}  # op name -> total device us
        self.counts: Dict[str, int] = {}
        self.total_us: float = 0.0
        self.events: List[Tuple[float, float, str]] = []

    def _ingest(self, trace_dir: str) -> None:
        """Read every Chrome trace (``*.json`` or ``*.json.gz``) under
        ``trace_dir`` and keep its device operations."""
        files = glob.glob(os.path.join(trace_dir, "**", "*.json"), recursive=True)
        files += glob.glob(os.path.join(trace_dir, "**", "*.json.gz"), recursive=True)
        events = []
        for f in files:
            with (gzip.open(f, "rt") if f.endswith(".gz") else open(f)) as fh:
                data = json.load(fh)
            for e in data.get("traceEvents", []):
                if e.get("ph") == "X" and "dur" in e and e.get("cat") in DEVICE_CATEGORIES:
                    events.append((float(e["ts"]), float(e["dur"]), e["name"]))
        events.sort()
        dur: collections.Counter = collections.Counter()
        cnt: collections.Counter = collections.Counter()
        total, end = 0.0, float("-inf")
        for start, d, name in events:
            dur[name] += d
            cnt[name] += 1
            total += d - min(d, max(0.0, end - start))  # its duration less its overlap with the earlier ones
            end = max(end, start + d)
        self.times, self.counts, self.total_us, self.events = dict(dur), dict(cnt), total, events

    def report(self, top: int = 15, min_us: float = 1.0) -> str:
        rows = sorted(self.times.items(), key=lambda kv: -kv[1])
        lines = [f"device total: {self.total_us:.0f} us"]
        for name, us in rows[:top]:
            if us < min_us:
                break
            lines.append(f"{us:10.1f} us  x{self.counts.get(name, 0):5d}  {name[:90]}")
        return "\n".join(lines)


@contextmanager
def device_profile(trace_dir: Optional[str] = None, keep: bool = False):
    """Context manager: profile the enclosed work and expose per-operation
    device times. The block ends with ``torch.cuda.synchronize()`` (where
    there is a card), so trailing kernels are in the trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    own = trace_dir is None
    if own:
        trace_dir = tempfile.mkdtemp(prefix="deodr_torch_trace_")
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    prof = DeviceProfile()
    try:
        with profile(activities=activities) as p:
            yield prof
            if cuda:
                torch.cuda.synchronize()
        os.makedirs(trace_dir, exist_ok=True)
        p.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
        prof._ingest(trace_dir)
    finally:
        if own and not keep:
            shutil.rmtree(trace_dir, ignore_errors=True)
