"""Per-triangle setup rows for the solid (z-buffered) pass.

PyTorch counterpart of ``TriangleRowSetup`` / ``triangle_row_setup`` in
``deodr_tpu/ops/raster.py``: the upper/lower scanline parts, their left and
right edge equations, the clamped bounding box and the affine depth map of
each triangle. The tiled kernel turns these into its coverage predicate.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from deodr_tpu_torch.ops.common import edge_equations, safe_barycentric_matrices


class TriangleRowSetup(NamedTuple):
    """Per-triangle scalars consumed by the winner resolution."""

    y_lo: torch.Tensor  # (T, 2) first row of upper/lower part
    y_hi: torch.Tensor  # (T, 2) last row of upper/lower part
    left_eq: torch.Tensor  # (T, 2, 3) left edge equation per part
    right_eq: torch.Tensor  # (T, 2, 3) right edge equation per part
    x_lo: torch.Tensor  # (T,) clamped bbox x min
    x_hi: torch.Tensor  # (T,) clamped bbox x max
    z_coef: torch.Tensor  # (T, 3) affine map (x, y, 1) → z
    valid: torch.Tensor  # (T,) drawn at all


def _sel3(a: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """a (T, 3[, ...]) element/row select by per-triangle index."""
    shape = ids.shape + (1,) * (a.ndim - 2)
    c0 = (ids == 0).reshape(shape)
    c1 = (ids == 1).reshape(shape)
    return torch.where(c0, a[:, 0], torch.where(c1, a[:, 1], a[:, 2]))


def triangle_row_setup(
    v_xy: torch.Tensor,
    v_z: torch.Tensor,
    draw: torch.Tensor,
    width: int,
    height: int,
) -> TriangleRowSetup:
    """Setup rows for ``strict_edge`` and affine (not perspective-correct)
    depth, the only mode this package renders. Ties of the 3-element sort
    follow a stable argsort: first index of the minimum, last of the
    maximum."""
    u = v_xy[:, 1, :] - v_xy[:, 0, :]
    w = v_xy[:, 2, :] - v_xy[:, 0, :]
    raw_cross = u[:, 0] * w[:, 1] - w[:, 0] * u[:, 1]
    eq = edge_equations(v_xy, raw_cross > 0)  # (T, 3, 3)

    y0, y1, y2 = v_xy[:, 0, 1], v_xy[:, 1, 1], v_xy[:, 2, 1]
    x0, x1, x2 = v_xy[:, 0, 0], v_xy[:, 1, 0], v_xy[:, 2, 0]
    zero, one, two = (torch.full_like(y0, v, dtype=torch.int64) for v in (0, 1, 2))
    id0 = torch.where((y0 <= y1) & (y0 <= y2), zero, torch.where(y1 <= y2, one, two))
    id2 = torch.where((y2 >= y0) & (y2 >= y1), two, torch.where(y1 >= y0, one, zero))
    ys0 = torch.minimum(torch.minimum(y0, y1), y2)
    ys2 = torch.maximum(torch.maximum(y0, y1), y2)
    ys1 = torch.maximum(torch.minimum(y0, y1), torch.minimum(torch.maximum(y0, y1), y2))
    xs_lo = torch.minimum(torch.minimum(x0, x1), x2)
    xs_hi = torch.maximum(torch.maximum(x0, x1), x2)

    # upper part: edges adjacent to the topmost vertex, the one with a > 0
    # is the left edge; lower part mirrored around the bottom vertex
    id0p2 = (id0 + 2) % 3
    a0 = _sel3(eq[:, :, 0], id0)
    left0 = torch.where(a0 > 0, id0, id0p2)
    right0 = torch.where(a0 > 0, id0p2, id0)
    id2p2 = (id2 + 2) % 3
    a2 = _sel3(eq[:, :, 0], id2)
    right1 = torch.where(a2 < 0, id2, id2p2)
    left1 = torch.where(a2 < 0, id2p2, id2)

    left_eq = torch.stack([_sel3(eq, left0), _sel3(eq, left1)], dim=1)
    right_eq = torch.stack([_sel3(eq, right0), _sel3(eq, right1)], dim=1)

    y_lo = torch.stack([torch.floor(ys0) + 1, torch.floor(ys1) + 1], dim=1).clamp_min(0.0)
    y_hi = torch.stack([torch.floor(ys1), torch.floor(ys2)], dim=1).clamp_max(float(height - 1))
    x_lo = torch.floor(xs_lo).clamp_min(0.0)
    x_hi = torch.floor(xs_hi).clamp_max(float(width - 1))

    xy1_to_bary, bary_valid = safe_barycentric_matrices(v_xy)  # (T, 3, 3), (T,)
    z_coef = v_z[:, 0, None] * xy1_to_bary[:, 0] + v_z[:, 1, None] * xy1_to_bary[:, 1] + v_z[:, 2, None] * xy1_to_bary[:, 2]
    finite = bary_valid & torch.isfinite(z_coef).all(dim=1)
    return TriangleRowSetup(y_lo, y_hi, left_eq, right_eq, x_lo, x_hi, z_coef, draw & finite)
