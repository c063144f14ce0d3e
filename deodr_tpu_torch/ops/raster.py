"""Solid (z-buffered) triangle rasterization: per-triangle setup rows, and
the untiled solid pass.

PyTorch counterpart of ``deodr_tpu/ops/raster.py``: ``triangle_row_setup``
(the upper/lower scanline parts, their left and right edge equations, the
clamped bounding box and the depth map of each triangle, which the tiled
kernel turns into its coverage predicate), and the untiled pass of
``render_scene(tiling=None)``: ``find_winners`` resolves each pixel's
visible triangle by a z-argmin over chunks of triangles with the rational
x-range rule, ``shade_pixels`` shades the winners differentiably (the
winner is a constant, gradients flow through the barycentric matrices).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from deodr_tpu_torch.ops.common import bilinear_sample, ceil_div, edge_equations, floor_div, safe_barycentric_matrices


class TriangleRowSetup(NamedTuple):
    """Per-triangle scalars consumed by the winner resolution."""

    y_lo: torch.Tensor  # (T, 2) first row of upper/lower part
    y_hi: torch.Tensor  # (T, 2) last row of upper/lower part
    left_eq: torch.Tensor  # (T, 2, 3) left edge equation per part
    right_eq: torch.Tensor  # (T, 2, 3) right edge equation per part
    x_lo: torch.Tensor  # (T,) clamped bbox x min
    x_hi: torch.Tensor  # (T,) clamped bbox x max
    z_coef: torch.Tensor  # (T, 3) affine map (x, y, 1) → z (perspective: → 1/z)
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
    strict_edge: bool = True,
    perspective_correct: bool = False,
) -> TriangleRowSetup:
    """Setup rows of each triangle. ``strict_edge`` starts a part's rows
    and the bounding box at floor + 1 (a shared edge is drawn once), else at
    the ceiling; ``perspective_correct`` makes ``z_coef`` the affine map of
    1/z, and a triangle with a zero depth invalid. Ties of the 3-element
    sort follow a stable argsort: first index of the minimum, last of the
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

    if strict_edge:
        y_lo = torch.stack([torch.floor(ys0) + 1, torch.floor(ys1) + 1], dim=1)
        x_lo = torch.floor(xs_lo)
    else:
        y_lo = torch.stack([torch.ceil(ys0), torch.ceil(ys1)], dim=1)
        x_lo = torch.ceil(xs_lo)
    y_lo = y_lo.clamp_min(0.0)
    x_lo = x_lo.clamp_min(0.0)
    y_hi = torch.stack([torch.floor(ys1), torch.floor(ys2)], dim=1).clamp_max(float(height - 1))
    x_hi = torch.floor(xs_hi).clamp_max(float(width - 1))

    xy1_to_bary, bary_valid = safe_barycentric_matrices(v_xy)  # (T, 3, 3), (T,)
    if perspective_correct:
        z_src = 1.0 / torch.where(v_z == 0, 1.0, v_z)
        bary_valid = bary_valid & (v_z != 0).all(dim=1)
    else:
        z_src = v_z
    z_coef = z_src[:, 0, None] * xy1_to_bary[:, 0] + z_src[:, 1, None] * xy1_to_bary[:, 1] + z_src[:, 2, None] * xy1_to_bary[:, 2]
    finite = bary_valid & torch.isfinite(z_coef).all(dim=1)
    return TriangleRowSetup(y_lo, y_hi, left_eq, right_eq, x_lo, x_hi, z_coef, draw & finite)


def find_winners(v_xy, v_z, draw, width: int, height: int, strict_edge: bool = True,
                 perspective_correct: bool = False, chunk: int = 64):
    """Per-pixel visibility of the untiled pass → (winner (H, W) int64, −1
    where nothing covers; z_buffer (H, W), +inf there). A z-argmin over
    chunks of ``chunk`` triangles: each (triangle, row) covers the columns of
    the rational x-range rule (the reference's ``get_xrange``), and ties in
    z go to the lowest triangle index (``torch.argmin`` returns the first
    minimum; a later chunk must be strictly nearer). Not differentiable:
    visibility is discrete, and the z-buffer is a constant of the backward."""
    v_xy, v_z = v_xy.detach(), v_z.detach()
    dtype, dev = v_xy.dtype, v_xy.device
    s = triangle_row_setup(v_xy, v_z, draw, width, height, strict_edge, perspective_correct)
    yy = torch.arange(height, dtype=dtype, device=dev)
    xx = torch.arange(width, dtype=dtype, device=dev)
    best_z = torch.full((height, width), float("inf"), dtype=dtype, device=dev)
    best_i = torch.full((height, width), -1, dtype=torch.int64, device=dev)
    for base in range(0, v_xy.shape[0], chunk):
        c = slice(base, base + chunk)
        eq_l, eq_r, x_lo, x_hi = s.left_eq[c], s.right_eq[c], s.x_lo[c], s.x_hi[c]
        num_l = -(eq_l[:, :, None, 1] * yy + eq_l[:, :, None, 2])  # (Tc, 2, H)
        num_r = -(eq_r[:, :, None, 1] * yy + eq_r[:, :, None, 2])
        lo, hi = (x_lo - 1)[:, None, None], x_hi[:, None, None]
        if strict_edge:
            t_l = 1 + floor_div(num_l, eq_l[:, :, None, 0], lo, hi)
        else:
            t_l = ceil_div(num_l, eq_l[:, :, None, 0], lo, hi)
        t_r = floor_div(num_r, eq_r[:, :, None, 0], lo, hi)
        x_begin = torch.maximum(x_lo[:, None, None], t_l)
        x_end = torch.minimum(x_hi[:, None, None], t_r)
        row_ok = (yy >= s.y_lo[c, :, None]) & (yy <= s.y_hi[c, :, None])  # (Tc, 2, H)
        cov = (row_ok[..., None] & (xx >= x_begin[..., None]) & (xx <= x_end[..., None])).any(dim=1)
        z = s.z_coef[c, 0, None, None] * xx + (s.z_coef[c, 1, None, None] * yy[:, None] + s.z_coef[c, 2, None, None])
        if perspective_correct:
            z = 1.0 / z
        z_eff = torch.where(cov & s.valid[c, None, None] & torch.isfinite(z), z, float("inf"))
        c_i = z_eff.argmin(dim=0)
        c_z = z_eff.gather(0, c_i[None])[0]
        better = c_z < best_z
        best_z = torch.where(better, c_z, best_z)
        best_i = torch.where(better, base + c_i, best_i)
    return best_i, best_z


def _gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` as ``index_select``, whose backward is one
    ``index_add_`` (plain indexing sorts the indices in its backward)."""
    return table.index_select(0, idx.reshape(-1)).reshape(idx.shape + table.shape[1:])


def _bary_dot(bary, vals):
    """Σ_k bary[..., k] · vals[..., k, c] in a fixed order → (..., C)."""
    b = bary[..., None]
    return b[..., 0, :] * vals[..., 0, :] + b[..., 1, :] * vals[..., 1, :] + b[..., 2, :] * vals[..., 2, :]


def interpolate_at_pixels(bary, corner_vals, corner_z, perspective_correct: bool):
    """Barycentric interpolation of per-corner values at pixels: bary
    (..., 3), corner_vals (..., 3, C) or (..., 3), corner_z (..., 3). The
    perspective-correct mode interpolates value / z and multiplies by the
    interpolated depth."""
    squeeze = corner_vals.ndim == bary.ndim
    if squeeze:
        corner_vals = corner_vals[..., None]
    if perspective_correct:
        w = bary * (1.0 / corner_z)
        big_z = 1.0 / (w[..., 0] + w[..., 1] + w[..., 2])
        out = _bary_dot(w, corner_vals) * big_z[..., None]
    else:
        out = _bary_dot(bary, corner_vals)
    return out[..., 0] if squeeze else out


def shade_pixels(winner, ij_off, depths, faces, faces_uv, colors, uv, shade, textured, shaded, texture, background,
                 perspective_correct: bool = False):
    """Differentiable shading of the resolved pixels → image (H, W, C).
    ``winner`` is a constant; every pixel gathers its winner's corners
    (triangle 0 where nothing covers, whose result is replaced by the
    background), so gradients reach ``ij_off`` through the barycentric
    matrices and the colors, uv, shade and texture through the weights."""
    height, width = winner.shape
    covered = winner >= 0
    tri = winner.clamp_min(0)
    f = faces[tri]  # (H, W, 3)
    v_xy = _gather(ij_off, f)  # (H, W, 3, 2)
    v_z = _gather(depths, f)  # (H, W, 3)
    dtype, dev = ij_off.dtype, ij_off.device
    x = torch.arange(width, dtype=dtype, device=dev)[None, :]
    y = torch.arange(height, dtype=dtype, device=dev)[:, None]
    # safe inverse: a pixel nothing covers gathers triangle 0, whose singular
    # inverse would put NaN into the backward
    m, _ = safe_barycentric_matrices(v_xy)  # (H, W, 3, 3)
    bary = m[..., 0] * x[..., None] + m[..., 1] * y[..., None] + m[..., 2]  # (H, W, 3)
    pix = interpolate_at_pixels(bary, _gather(colors, f), v_z, perspective_correct)
    if texture is not None:
        uv_px = interpolate_at_pixels(bary, _gather(uv, faces_uv[tri]), v_z, perspective_correct)
        lum = interpolate_at_pixels(bary, _gather(shade, f), v_z, perspective_correct)
        tex_px = bilinear_sample(texture, uv_px) * lum[..., None]
        use_tex = (textured & shaded)[tri][..., None]
        pix = torch.where(use_tex, tex_px, pix)
    pix = torch.where(torch.isfinite(pix), pix, 0.0)
    return torch.where(covered[..., None], pix, background)
