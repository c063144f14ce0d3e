"""The benchmark's command on the card: one short run of each cell from a
copy of the checkout, with the result line's device and metrics. Skips
where there is no card (decided inside the test)."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from perfbench.tests.small import CHECKOUT

CELLS = ("sphere131k_2048_f64.adam_s1", "sphere131k_2048_f32.adam_s1")


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_on_the_card(cell, trace):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    proc = subprocess.run([sys.executable, "perfbench/run.py", "--workload", cell, "--seed", str(2**31 + 101),
                           "--seconds", "3", "--trace", str(trace)], cwd=CHECKOUT, capture_output=True, text=True,
                          timeout=360)
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["kind"] == torch.cuda.get_device_name(0)
    names = {"step_ms", "step_p95_ms", "peak_mem_gib", "setup_s"} if not trace else {
        "device_ops_per_step", "glue_ms", "kernel_ms", "kernel_roofline_pct", "device_idle_pct"}
    assert set(line["metrics"]) == names
