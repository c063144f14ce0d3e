"""The numbers that decide ``correct``: the program's first steps of the
fit against the reference's, on the same inputs.

- ``loss_gap``: the largest relative gap of a step's loss over the checked
  steps;
- ``grad_gap``: the worst leaf's gap between the norms of the first
  gradient (the program's as Adam received it), over the larger of the
  reference's norm of that leaf and of the median leaf;
- ``grad_clip_gap``: the same with every row of both gradients (a vertex's
  three components) clipped to the reference's row norm at the
  ``CLIP_QUANTILE`` quantile of that leaf, a rule on the reference's
  gradient: a few rows of sliver triangles, whose gradients scale as one
  over their screen area, no longer decide the norm, while a gradient of
  the wrong size over the many other rows still shows;
- ``change_gap``: as ``grad_gap``, for the norm of each leaf's change over
  the checked steps, over the leaves whose reference gradient is at least
  a thousandth of the median leaf's (a leaf below that moves by round-off
  alone under Adam).

A number that is not finite reads as the largest float, so it fails its
limit.
"""

from __future__ import annotations

import math
import statistics
import sys

import torch

from perfbench.reference import FitResult

NUMBERS = ("loss_gap", "grad_gap", "grad_clip_gap", "change_gap")
CLIP_QUANTILE = 0.999


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def _finite(x: float) -> float:
    return x if math.isfinite(x) else sys.float_info.max


def _clipped(g: torch.Tensor, level: float) -> torch.Tensor:
    rows = g.double().reshape(g.shape[0], -1)
    return rows * (level / torch.linalg.vector_norm(rows, dim=1, keepdim=True).clamp_min(level)).clamp_max(1.0)


def _grad_gap(program: dict, reference: dict) -> float:
    g_ref = {k: _norm(g) for k, g in reference.items()}
    g_med = statistics.median(g_ref.values())
    return max(abs(_norm(program[k]) - g_ref[k]) / max(g_ref[k], g_med) for k in g_ref)


def _clip_levels(reference: dict, q: float) -> dict:
    return {k: float(torch.quantile(torch.linalg.vector_norm(g.double().reshape(g.shape[0], -1), dim=1), q))
            for k, g in reference.items()}


def gaps(program: FitResult, reference: FitResult, start: dict) -> dict:
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(program.losses, reference.losses))
    grad_gap = _grad_gap(program.first_grads, reference.first_grads)
    levels = _clip_levels(reference.first_grads, CLIP_QUANTILE)
    grad_clip_gap = _grad_gap({k: _clipped(g, levels[k]) for k, g in program.first_grads.items()},
                              {k: _clipped(g, levels[k]) for k, g in reference.first_grads.items()})
    g_ref = {k: _norm(g) for k, g in reference.first_grads.items()}
    g_med = statistics.median(g_ref.values())
    moved = [k for k in g_ref if g_ref[k] >= 1e-3 * g_med]
    d_ref = {k: _norm(reference.params[k].double() - start[k].double()) for k in moved}
    d_med = statistics.median(d_ref.values())
    change_gap = max(
        abs(_norm(program.params[k].double() - start[k].double()) - d_ref[k]) / max(d_ref[k], d_med) for k in moved
    )
    return {"loss_gap": _finite(loss_gap), "grad_gap": _finite(grad_gap), "grad_clip_gap": _finite(grad_clip_gap),
            "change_gap": _finite(change_gap)}


def judge(numbers: dict, limits: dict):
    """(correct, {name: {"value", "limit"}}) for every number the cell's
    limits file names; a number it leaves out is not compared."""
    checks = {name: {"value": numbers[name], "limit": float(limits["limits"][name])}
              for name in NUMBERS if name in limits["limits"]}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks
