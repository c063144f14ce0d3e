"""The discontinuity-edge-overdraw pass: per-edge records and the
sequential pass.

PyTorch counterpart of ``deodr_tpu/ops/edge_aa.py``. Along each silhouette
edge of a front-facing triangle a band of width ``sigma`` is blended over
the framebuffer, ``out = T·in + (1 − T)·A``, back to front and only over
strictly farther geometry. The tiled kernels in
:mod:`deodr_tpu_torch.ops.kernels.edge_kernel` (untextured scenes) and
:mod:`deodr_tpu_torch.ops.kernels.edge_tex_kernel` (textured and mixed
scenes) blend on the tiled route; :func:`edge_overdraw_pass` here blends one
edge after the other, as ``edge_overdraw_pass`` and
``edge_overdraw_pass_windowed`` of the JAX package do, for the untiled route
and for what the kernels do not cover (perspective-correct edges, a textured
scene without a texture plan). Its backward runs the edges in reverse and
un-blends the buffer in place, so its memory does not grow with the number
of edges.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch

from deodr_tpu_torch.ops.common import bilinear_sample, floor_div, inv3x3


class EdgeData(NamedTuple):
    """Per-edge tensors, sorted back to front (leading axis = edge)."""

    v0: torch.Tensor  # (E, 2) first endpoint (x, y), pixel offset applied
    v1: torch.Tensor  # (E, 2) second endpoint
    z: torch.Tensor  # (E, 2) endpoint depths
    attrs: torch.Tensor  # (E, 2, C) endpoint colors
    uvs: torch.Tensor  # (E, 2, 2) endpoint texture coordinates (u, v)
    shades: torch.Tensor  # (E, 2) endpoint Gouraud shade
    active: torch.Tensor  # (E,) bool
    use_texture: torch.Tensor  # (E,) bool, the edge's triangle is textured and shaded


class EdgeAAConfig(NamedTuple):
    """Static configuration of the edge pass."""

    height: int
    width: int
    sigma: float
    clockwise: bool
    error_mode: bool
    has_texture: bool = False
    perspective_correct: bool = False


# the |T| floor of the un-blend's division (deodr_tpu/ops/edge_aa.py, _t_div)
_T_DIV_EPS = 1e-6


def edge_stencils(cfg: EdgeAAConfig, v0: torch.Tensor, v1: torch.Tensor):
    """Per-edge band stencils of the sequential pass, for all E edges at
    once: the affine maps (x, y, 1) → (b0, b1) and → T of each edge, from
    the inverse of [[v0 v1 n], [1 1 0]] (n the unit outward normal), and
    whether the edge is usable → (bary (E, 2, 3), t_coef (E, 3), edge_ok (E,),
    y_lo (E,), y_hi (E,)). Differentiable in v0 and v1. A degenerate edge
    (non-finite, or shorter than the float noise of its coordinates) is
    replaced by the unit edge (0, 0)–(1, 0) before the inverse, so no
    inf/NaN reaches the backward, and is not usable; ``y_lo``/``y_hi`` are
    the band's clamped row range."""
    dtype = v0.dtype
    d = v1 - v0
    len2 = d[:, 0] ** 2 + d[:, 1] ** 2
    eps = torch.finfo(dtype).eps
    scale2 = torch.clamp_min(v0[:, 0] ** 2 + v0[:, 1] ** 2 + v1[:, 0] ** 2 + v1[:, 1] ** 2, 1.0)
    edge_ok = torch.isfinite(len2) & (len2 > (100.0 * eps) ** 2 * scale2) & torch.isfinite(v0[:, 0] + v0[:, 1])
    edge_ok = edge_ok.detach()
    zero = torch.zeros_like(v0)
    unit = torch.eye(1, 2, dtype=dtype, device=v0.device).expand_as(v0)
    v0 = torch.where(edge_ok[:, None], v0, zero)
    v1 = torch.where(edge_ok[:, None], v1, unit)
    if cfg.clockwise:
        n = torch.stack([v0[:, 1] - v1[:, 1], v1[:, 0] - v0[:, 0]], dim=1)
    else:
        n = torch.stack([v1[:, 1] - v0[:, 1], v0[:, 0] - v1[:, 0]], dim=1)
    n = n / torch.sqrt(n[:, 0:1] ** 2 + n[:, 1:2] ** 2)
    ones = torch.ones_like(v0[:, 0])
    m = torch.stack([
        torch.stack([v0[:, 0], v1[:, 0], n[:, 0]], dim=1),
        torch.stack([v0[:, 1], v1[:, 1], n[:, 1]], dim=1),
        torch.stack([ones, ones, torch.zeros_like(ones)], dim=1),
    ], dim=1)
    inv = inv3x3(m)
    y0, y1 = v0[:, 1].detach(), v1[:, 1].detach()
    y_lo = torch.clamp_min(torch.floor(torch.minimum(y0, y1) - cfg.sigma) + 1, 0.0)
    y_hi = torch.clamp_max(torch.floor(torch.maximum(y0, y1) + cfg.sigma), float(cfg.height - 1))
    return inv[:, :2], inv[:, 2] / cfg.sigma, edge_ok, y_lo, y_hi


def band_x_ranges(cfg: EdgeAAConfig, bary, t_coef, rows):
    """The band's columns on each of the rows ``rows`` (E, R) of each edge →
    (x_begin, x_end), each (E, R): the four band inequalities b0 > 0,
    b1 > 0, T > 0 and 1 − T > 0 refined one after the other with the
    rational rule, in the reference's loop order. Not differentiable."""
    bary, t_coef = bary.detach(), t_coef.detach()
    ineq = torch.stack([bary[:, 0], bary[:, 1], t_coef,
                        torch.stack([-t_coef[:, 0], -t_coef[:, 1], 1.0 - t_coef[:, 2]], dim=1)], dim=1)  # (E, 4, 3)
    x_begin = torch.zeros_like(rows)
    x_end = torch.full_like(rows, float(cfg.width - 1))
    for k in range(4):
        a, b, c = ineq[:, k, 0, None], ineq[:, k, 1, None], ineq[:, k, 2, None]
        fd = floor_div(-(b * rows + c), a, x_begin - 1, x_end + 1)
        x_end = torch.where(a < 0, torch.minimum(x_end, fd), x_end)
        x_begin = torch.where(a < 0, x_begin, torch.maximum(x_begin, 1 + fd))
    return x_begin, x_end


def window_origins(cfg: EdgeAAConfig, v0, v1, win):
    """Top-left (row, column) of each edge's ``win``-shaped window: the
    edge's bounding box grown by sigma, clamped into the frame → (oy, ox),
    each (E,) int64."""
    lo = torch.minimum(v0, v1).detach() - cfg.sigma
    oy = torch.nan_to_num(torch.floor(lo[:, 1])).clamp(0, max(cfg.height - win[0], 0))
    ox = torch.nan_to_num(torch.floor(lo[:, 0])).clamp(0, max(cfg.width - win[1], 0))
    return oy.to(torch.int64), ox.to(torch.int64)


class _Plan(NamedTuple):
    """What the pass's steps share: the configuration, the window shape,
    the steps (edge, row origin, column origin) of the edges that can blend
    a pixel, in painter's order, each edge's rows and columns (x_begin,
    x_end, row_ok, each (E, R)), whether each edge samples the texture, and
    the constants z_buffer and obs."""

    cfg: EdgeAAConfig
    win: Tuple[int, int]
    steps: List[Tuple[int, int, int]]
    x_begin: torch.Tensor
    x_end: torch.Tensor
    row_ok: torch.Tensor
    use_texture: List[bool]
    z_buffer: torch.Tensor
    obs: Optional[torch.Tensor]


def _fragment(plan: _Plan, e, oy, ox, bary, t_coef, z, attrs, uvs, shades, texture):
    """Blend mask, transparency T and edge value A of edge ``e`` on its
    window at (oy, ox) → (mask (wh, ww), t, a (wh, ww, C)), in global pixel
    coordinates; ``bary`` ... ``shades`` are the edge's rows. Follows
    ``_edge_fragment`` of the JAX package: the depth is a constant (z-test
    only), masked pixels get T = 0.5 and A = 0."""
    cfg = plan.cfg
    wh, ww = plan.win
    dtype, dev = bary.dtype, bary.device
    yy = (oy + torch.arange(wh, dtype=dtype, device=dev))[:, None]
    xx = (ox + torch.arange(ww, dtype=dtype, device=dev))[None, :]
    cov = plan.row_ok[e][:, None] & (xx >= plan.x_begin[e][:, None]) & (xx <= plan.x_end[e][:, None])
    b0 = bary[0, 0] * xx + bary[0, 1] * yy + bary[0, 2]
    b1 = bary[1, 0] * xx + bary[1, 1] * yy + bary[1, 2]
    t = t_coef[0] * xx + t_coef[1] * yy + t_coef[2]
    if cfg.perspective_correct:
        z_px = (1.0 / (b0 / z[0] + b1 / z[1])).detach()
    else:
        z_px = (b0 * z[0] + b1 * z[1]).detach()
    mask = cov & (z_px < plan.z_buffer[oy : oy + wh, ox : ox + ww]) & torch.isfinite(t)
    t = torch.where(mask, t, 0.5)
    b0 = torch.where(mask, b0, 0.0)
    b1 = torch.where(mask, b1, 0.0)

    def interp(a0, a1):
        if cfg.perspective_correct:
            return (b0[..., None] * a0 / z[0] + b1[..., None] * a1 / z[1]) * z_px[..., None]
        return b0[..., None] * a0 + b1[..., None] * a1

    if plan.use_texture[e]:
        uv_px = interp(uvs[0], uvs[1])
        if cfg.perspective_correct:
            lum = (b0 * shades[0] / z[0] + b1 * shades[1] / z[1]) * z_px
        else:
            lum = b0 * shades[0] + b1 * shades[1]
        a = bilinear_sample(texture, uv_px) * lum[..., None]
    else:
        a = interp(attrs[0], attrs[1])
    return mask, t, torch.where(mask[..., None], a, 0.0)


def _blend(plan: _Plan, buf, mask, t, a, oy, ox):
    """One painter's blend on a window: buf ← T·buf + (1 − T)·A where
    ``mask`` (error mode: the squared residual of A against obs)."""
    if plan.cfg.error_mode:
        wh, ww = plan.win
        obs = plan.obs[oy : oy + wh, ox : ox + ww]
        err = ((a - torch.where(mask[..., None], obs, 0.0)) ** 2).sum(dim=-1)
        return torch.where(mask, t * buf + (1 - t) * err, buf)
    return torch.where(mask[..., None], t[..., None] * buf + (1 - t[..., None]) * a, buf)


def _unblend(plan: _Plan, buf, mask, t, a, oy, ox):
    """The buffer before a blend, from the buffer after it: divided by T
    floored to ±1e-6 (a pixel the rational range admits can have T = 0)."""
    t_div = torch.where(t.abs() < _T_DIV_EPS, torch.where(t < 0, -_T_DIV_EPS, _T_DIV_EPS), t)
    if plan.cfg.error_mode:
        wh, ww = plan.win
        obs = plan.obs[oy : oy + wh, ox : ox + ww]
        err = ((a - torch.where(mask[..., None], obs, 0.0)) ** 2).sum(dim=-1)
        return torch.where(mask, (buf - (1 - t) * err) / t_div, buf)
    return torch.where(mask[..., None], (buf - (1 - t[..., None]) * a) / t_div[..., None], buf)


class _EdgeOverdraw(torch.autograd.Function):
    """The sequential pass over precomputed per-edge rows. The forward
    blends the steps in order without recording a graph; the backward walks
    them in reverse, un-blends the buffer in place and takes each step's
    gradients with ``torch.autograd.grad`` of that step, as the JAX backward
    takes ``jax.vjp`` of each step."""

    @staticmethod
    def forward(ctx, plan: _Plan, buffer0, bary, t_coef, z, attrs, uvs, shades, texture):
        wh, ww = plan.win
        buf = buffer0.detach().clone()
        with torch.no_grad():
            for e, oy, ox in plan.steps:
                mask, t, a = _fragment(plan, e, oy, ox, bary[e], t_coef[e], z[e], attrs[e], uvs[e], shades[e], texture)
                w = buf[oy : oy + wh, ox : ox + ww]
                w.copy_(_blend(plan, w, mask, t, a, oy, ox))
        ctx.plan = plan
        ctx.has_texture = texture is not None
        ctx.save_for_backward(buf, bary, t_coef, z, attrs, uvs, shades, *(() if texture is None else (texture,)))
        return buf

    @staticmethod
    def backward(ctx, g_out):
        plan = ctx.plan
        wh, ww = plan.win
        buf, *rows = ctx.saved_tensors[:7]
        texture = ctx.saved_tensors[7].detach().requires_grad_(True) if ctx.has_texture else None
        buf = buf.clone()
        g_buf = g_out.clone()
        g_rows = [torch.zeros_like(r) for r in rows]
        g_tex = torch.zeros_like(texture) if texture is not None else None
        for e, oy, ox in reversed(plan.steps):
            leaves = [r[e].detach().requires_grad_(True) for r in rows]
            with torch.enable_grad():
                mask, t, a = _fragment(plan, e, oy, ox, *leaves, texture)
            w = buf[oy : oy + wh, ox : ox + ww]
            before = _unblend(plan, w, mask, t.detach(), a.detach(), oy, ox).requires_grad_(True)
            inputs = [before] + leaves + ([texture] if plan.use_texture[e] else [])
            with torch.enable_grad():
                out = _blend(plan, before, mask, t, a, oy, ox)
                grads = torch.autograd.grad(out, inputs, g_buf[oy : oy + wh, ox : ox + ww], allow_unused=True)
            w.copy_(before.detach())
            g_buf[oy : oy + wh, ox : ox + ww] = grads[0]
            for g_row, g in zip(g_rows, grads[1:7]):
                if g is not None:
                    g_row[e] += g
            if len(grads) > 7 and grads[7] is not None:
                g_tex += grads[7]
        return (None, g_buf, *g_rows, g_tex)


def edge_overdraw_pass(cfg: EdgeAAConfig, buffer0, edges: EdgeData, texture, z_buffer, obs, win=None):
    """Composite the bands of ``edges`` (back to front) over ``buffer0``
    ((H, W, C), or (H, W) in error mode, blending the squared residual
    against ``obs``) one edge after the other → the new buffer.
    Differentiable in ``buffer0``, the edges' rows and ``texture``;
    ``z_buffer`` and ``obs`` are constants.

    ``win`` = (wh, ww) restricts each edge's blend to a window of that shape
    holding its band (:func:`window_origins`), as the JAX package's
    ``edge_overdraw_pass_windowed`` does: the result is the full pass's
    wherever the window holds the band (callers size it from the largest
    band). Texels are read from the whole texture, so the JAX package's
    ``aa_tex_window`` has no counterpart here. One host read finds the
    edges that can blend a pixel and their windows; the others are skipped."""
    height, width = cfg.height, cfg.width
    win = (height, width) if win is None else (int(win[0]), int(win[1]))
    bary, t_coef, edge_ok, y_lo, y_hi = edge_stencils(cfg, edges.v0, edges.v1)
    if win == (height, width):
        oy = ox = torch.zeros_like(y_lo, dtype=torch.int64)
    else:
        oy, ox = window_origins(cfg, edges.v0, edges.v1, win)
    rows = oy[:, None].to(bary.dtype) + torch.arange(win[0], dtype=bary.dtype, device=bary.device)  # (E, wh)
    x_begin, x_end = band_x_ranges(cfg, bary, t_coef, rows)
    row_ok = (rows >= y_lo[:, None]) & (rows <= y_hi[:, None])
    cols_ok = (x_begin <= x_end) & (x_end >= ox[:, None]) & (x_begin < (ox + win[1])[:, None])
    live = edges.active & edge_ok & (row_ok & cols_ok).any(dim=1)
    use_tex = edges.use_texture & cfg.has_texture
    flags = torch.stack([live.to(torch.int64), oy, ox, use_tex.to(torch.int64)]).tolist()  # the one host read
    steps = [(e, y, x) for e, (keep, y, x) in enumerate(zip(*flags[:3])) if keep]
    plan = _Plan(cfg, win, steps, x_begin, x_end, row_ok, [bool(u) for u in flags[3]], z_buffer.detach(),
                 None if obs is None else obs.detach())
    return _EdgeOverdraw.apply(plan, buffer0, bary, t_coef, edges.z, edges.attrs, edges.uvs, edges.shades,
                               texture if cfg.has_texture else None)

