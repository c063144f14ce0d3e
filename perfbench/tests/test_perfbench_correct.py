"""``correct`` on the CPU at a small size, with each cell's limits: a
sound run passes; a run with a fault planted under the timed path fails,
once for each fault a one-chip fit can have; and the control, the
reference computed one precision down in the program's place, fails."""

from __future__ import annotations

import pytest
import torch

from perfbench import compare, reference, run
from perfbench.calibrate import LOWER
from perfbench.faults import FAULTS
from perfbench.inputs import make_inputs
from perfbench.tests.small import small_root

CELLS = ("sphere131k_2048_f64.adam_s1", "sphere131k_2048_f32.adam_s1")


def _run(root, cell, seed):
    return run.run_cell(run.load_cell(root, cell), seed, 0.3, False, torch.device("cpu"), log=lambda *a, **k: None)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(tmp_path, cell):
    result = _run(small_root(tmp_path), cell, 2**31 + 11)
    assert result["correct"], result["checks"]


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_planted_fault_is_not_correct(tmp_path, cell, fault):
    root = small_root(tmp_path)
    with FAULTS[fault]():
        result = _run(root, cell, 2**31 + 13)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(tmp_path, cell):
    spec = run.load_cell(small_root(tmp_path), cell)
    n = int(spec.traffic["checked_steps"])
    for seed in (17, 18, 19):
        inputs = make_inputs(spec.config, spec.traffic, seed, torch.device("cpu"))
        start = {"vertices": inputs.vertices, "colors": inputs.colors}
        ref = reference.adam_fit(run.reference_scene(inputs), inputs.target, inputs.vertices, inputs.colors,
                                 spec.traffic, steps=n)
        control = reference.adam_fit(run.reference_scene(inputs), inputs.target, inputs.vertices, inputs.colors,
                                     spec.traffic, steps=n, dtype=getattr(torch, LOWER[spec.config["dtype"]]))
        correct, checks = compare.judge(compare.gaps(control, ref, start), spec.limits)
        assert not correct, (seed, checks)
