"""Per-edge records of the discontinuity-edge-overdraw pass.

PyTorch counterpart of ``EdgeData`` / ``EdgeAAConfig`` in
``deodr_tpu/ops/edge_aa.py``. Along each silhouette edge of a front-facing
triangle a band of width ``sigma`` is blended over the framebuffer,
``out = T·in + (1 − T)·A``, back to front and only over strictly farther
geometry; the tiled kernel in :mod:`deodr_tpu_torch.ops.kernels.edge_kernel`
does the blending.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class EdgeData(NamedTuple):
    """Per-edge tensors, sorted back to front (leading axis = edge)."""

    v0: torch.Tensor  # (E, 2) first endpoint (x, y), pixel offset applied
    v1: torch.Tensor  # (E, 2) second endpoint
    z: torch.Tensor  # (E, 2) endpoint depths
    attrs: torch.Tensor  # (E, 2, C) endpoint colors
    active: torch.Tensor  # (E,) bool


class EdgeAAConfig(NamedTuple):
    """Static configuration of the edge pass."""

    height: int
    width: int
    sigma: float
    clockwise: bool
    error_mode: bool
