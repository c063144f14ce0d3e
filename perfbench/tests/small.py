"""A copy of the benchmark's data at a size a CPU test can run: every file
of ``BENCHMARK.json`` and ``perfbench/`` data copied under a temporary root,
with the configurations' mesh and frame made small."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[2]
DATA_DIRS = ("configs", "traffic", "metrics", "kernels", "limits")


def small_root(root: Path, subdivisions: int = 3, size: int = 96) -> Path:
    """``root`` holding ``BENCHMARK.json`` and the data directories, each
    configuration cut to ``subdivisions`` and a ``size``² frame."""
    shutil.copy(CHECKOUT / "BENCHMARK.json", root / "BENCHMARK.json")
    for d in DATA_DIRS:
        shutil.copytree(CHECKOUT / "perfbench" / d, root / "perfbench" / d)
    for f in (root / "perfbench" / "configs").glob("*.json"):
        cfg = json.loads(f.read_text())
        cfg.update(subdivisions=subdivisions, height=size, width=size)
        f.write_text(json.dumps(cfg))
    return root
