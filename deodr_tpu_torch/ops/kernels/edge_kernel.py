"""Tiled silhouette edge-overdraw pass (untextured), forward and backward.

Counterpart of ``deodr_tpu/ops/pallas/edge_kernel.py`` (``_fwd_kernel``,
``_bwd_kernel`` under the ``edge_pass_pallas`` custom VJP). Per tile, back
to front over the binned edge slots::

    T = t·(x, y, 1)                    transparency ramp
    A = a·(x, y, 1)                    edge color (image mode), or the
                                       squared residual against obs (error mode)
    buf ← mask ? A + T·(buf − A) : buf

where the band mask is four thresholded planes plus the y-range, the
strict z-test against the solid pass's z-buffer, the active flag and a
finite T. The backward runs the loop in reverse and rebuilds the pre-blend
buffer by un-blending, buf = (out − A)·(1/T) + A, with |T| floored at 1e-6.

On a CUDA tensor the wrappers launch ``csrc/edge_kernel.cu``; on a CPU
tensor, or with ``impl="reference"``, they run the plain versions below,
which evaluate every plane in the kernel's operation order.

Edge-table row layout (width 25 + 3·C), one row per slot
(table_tile (n_tiles, cap, 25 + 3·C)):

  [band-clip inequality rows (4 x 3) | thresholds (4) | t coeffs (3) |
   y_begin | y_end | a coeffs (ax, ay, ac per channel) | z coeffs (3) | active]

Gradient rows (n_tiles, cap, 3 + 3·C): [g_t (3) | g_a (3 per channel)],
each as (Σ g·x, Σ g·y, Σ g); rows ≥ count are 0.
"""

from __future__ import annotations

import torch

from deodr_tpu_torch.ops import kernels
from deodr_tpu_torch.ops.kernels import TileGrid, from_tiles, tile_coords, to_tiles

_E_TH = 12
_E_T = 16
_E_YBEG, _E_YEND = 19, 20
_E_A = 21
T_DIV_EPS = 1e-6


def edge_row_width(nb_colors: int) -> int:
    return 25 + 3 * nb_colors


def grad_row_width(nb_colors: int) -> int:
    return 3 + 3 * nb_colors


def _e_z(nb_colors: int) -> int:
    return 21 + 3 * nb_colors


def _e_act(nb_colors: int) -> int:
    return 24 + 3 * nb_colors


def _plane(row, j, yy, xx):
    """Affine plane row[j]·x + (row[j+1]·y + row[j+2]) on the tile."""
    return row[:, j] * xx + (row[:, j + 1] * yy + row[:, j + 2])


def _band_mask_and_t(row, yy, xx, zb, c):
    t = _plane(row, _E_T, yy, xx)
    cov = None
    for i in range(4):
        ok = _plane(row, 3 * i, yy, xx) > row[:, _E_TH + i]
        cov = ok if cov is None else cov & ok
    cov = cov & (yy >= row[:, _E_YBEG]) & (yy <= row[:, _E_YEND])
    z = _plane(row, _e_z(c), yy, xx)
    mask = cov & (z < zb) & (row[:, _e_act(c)] > 0.5) & torch.isfinite(t)
    return mask, torch.where(mask, t, 0.5)


def _t_div(t):
    """|T| floored at 1e-6 for the un-blend division: the band test can
    admit a pixel whose float32 T is exactly 0."""
    return torch.where(t.abs() < T_DIV_EPS, torch.where(t < 0, -T_DIV_EPS, T_DIV_EPS), t)


def _sq_residual(a, obs_t):
    err = torch.zeros_like(a[0])
    for ch, a_ch in enumerate(a):
        diff = a_ch - obs_t[:, ch]
        err = err + diff * diff
    return err


def edge_fwd_reference(table_tile, buffer0, z_pad, obs_pad, counts, grid: TileGrid, error_mode: bool):
    """Plain version of the forward kernel; differentiable in
    ``table_tile`` and ``buffer0`` by autograd."""
    nt, cap, w = table_tile.shape
    c = (w - 25) // 3
    dtype, device = buffer0.dtype, buffer0.device
    yy, xx = tile_coords(grid, dtype, device)
    zb = to_tiles(z_pad, grid)
    obs_t = to_tiles(obs_pad, grid) if error_mode else None
    bufs = list(to_tiles(buffer0, grid).unbind(1))
    count = counts.to(torch.int64).clamp(max=cap)
    n_iter = int(count.max()) if nt else 0
    for k in range(n_iter):
        row = table_tile[:, k, :, None, None]
        mask, t = _band_mask_and_t(row, yy, xx, zb, c)
        mask = mask & (k < count)[:, None, None]
        a = [_plane(row, _E_A + 3 * ch, yy, xx) for ch in range(c)]
        if error_mode:
            a = [_sq_residual(a, obs_t)]
        bufs = [torch.where(mask, a[ch] + t * (bufs[ch] - a[ch]), bufs[ch]) for ch in range(len(bufs))]
    return from_tiles(torch.stack(bufs, dim=1), grid)


def edge_bwd_reference(table_tile, final, z_pad, obs_pad, g_out, counts, grid: TileGrid, error_mode: bool):
    """Plain version of the backward kernel → (g_rows (n_tiles, cap,
    3 + 3C), g_buf0 like ``final``)."""
    nt, cap, w = table_tile.shape
    c = (w - 25) // 3
    dtype, device = final.dtype, final.device
    yy, xx = tile_coords(grid, dtype, device)
    zb = to_tiles(z_pad, grid)
    obs_t = to_tiles(obs_pad, grid) if error_mode else None
    bufs = list(to_tiles(final, grid).unbind(1))
    gbufs = list(to_tiles(g_out, grid).unbind(1))
    count = counts.to(torch.int64).clamp(max=cap)
    g_rows = torch.zeros((nt, cap, grad_row_width(c)), dtype=dtype, device=device)
    n_iter = int(count.max()) if nt else 0
    for k in reversed(range(n_iter)):
        row = table_tile[:, k, :, None, None]
        mask, t = _band_mask_and_t(row, yy, xx, zb, c)
        mask = mask & (k < count)[:, None, None]
        rt = 1.0 / _t_div(t)
        one_minus_t = 1.0 - t
        a = [_plane(row, _E_A + 3 * ch, yy, xx) for ch in range(c)]
        if error_mode:
            err = _sq_residual(a, obs_t)
            before = torch.where(mask, (bufs[0] - err) * rt + err, bufs[0])
            g_o = gbufs[0]
            g_m = torch.where(mask, g_o, 0.0)
            g_t = g_m * (before - err)
            g_err = g_m * one_minus_t
            g_as = [g_err * 2.0 * (a[ch] - obs_t[:, ch]) for ch in range(c)]
            bufs = [before]
            gbufs = [torch.where(mask, t * g_o, g_o)]
        else:
            g_t = torch.zeros_like(t)
            g_as, new_bufs, new_gbufs = [], [], []
            for ch in range(c):
                before = torch.where(mask, (bufs[ch] - a[ch]) * rt + a[ch], bufs[ch])
                g_o = gbufs[ch]
                g_m = torch.where(mask, g_o, 0.0)
                g_t = g_t + g_m * (before - a[ch])
                g_as.append(g_m * one_minus_t)
                new_bufs.append(before)
                new_gbufs.append(torch.where(mask, t * g_o, g_o))
            bufs, gbufs = new_bufs, new_gbufs
        for q, g in enumerate([g_t] + g_as):
            g_rows[:, k, 3 * q] = (g * xx).sum(dim=(1, 2))
            g_rows[:, k, 3 * q + 1] = (g * yy).sum(dim=(1, 2))
            g_rows[:, k, 3 * q + 2] = g.sum(dim=(1, 2))
    return g_rows, from_tiles(torch.stack(gbufs, dim=1), grid)


def _check_inputs(table_tile, buf, z_pad, obs_pad, counts, grid, error_mode):
    kernels.check_float(buf, "buffer")
    dtype = buf.dtype
    nt, cap, w = table_tile.shape
    c = (w - 25) // 3
    if w != edge_row_width(c) or not 1 <= c <= 4:
        raise ValueError(f"table_tile: row width {w} is not 25 + 3·C for C in 1..4")
    hp, wp = grid.padded_hw
    kernels.check_tensor(table_tile, "table_tile", dtype, (grid.n_tiles, cap, w))
    kernels.check_tensor(buf, "buffer", dtype, (1 if error_mode else c, hp, wp))
    kernels.check_tensor(z_pad, "z_pad", dtype, (hp, wp))
    if error_mode:
        kernels.check_tensor(obs_pad, "obs_pad", dtype, (c, hp, wp))
    kernels.check_tensor(counts, "counts", torch.int32, (grid.n_tiles,))
    return c, cap


def edge_fwd(table_tile, buffer0, z_pad, obs_pad, counts, grid: TileGrid, error_mode: bool, impl: str = "kernel"):
    """Forward edge pass → blended buffer (nch, H', W'); ``obs_pad``
    (C, H', W') is read in error mode only (may be None otherwise)."""
    if not kernels.use_kernel(buffer0, impl):
        return edge_fwd_reference(table_tile, buffer0, z_pad, obs_pad, counts, grid, error_mode)
    c, cap = _check_inputs(table_tile, buffer0, z_pad, obs_pad, counts, grid, error_mode)
    out = torch.empty_like(buffer0)
    kernels.launch(
        "edge_fwd", buffer0.dtype,
        table_tile.data_ptr(), counts.data_ptr(), z_pad.data_ptr(),
        obs_pad.data_ptr() if error_mode else None, buffer0.data_ptr(),
        grid.n_tiles, grid.n_tx, grid.tile_h, grid.tile_w, cap, c, int(error_mode),
        out.data_ptr(),
    )
    return out


def edge_bwd(table_tile, final, z_pad, obs_pad, g_out, counts, grid: TileGrid, error_mode: bool,
             impl: str = "kernel"):
    """Backward edge pass → (g_rows (n_tiles, cap, 3 + 3C), g_buf0)."""
    if not kernels.use_kernel(final, impl):
        return edge_bwd_reference(table_tile, final, z_pad, obs_pad, g_out, counts, grid, error_mode)
    c, cap = _check_inputs(table_tile, final, z_pad, obs_pad, counts, grid, error_mode)
    kernels.check_tensor(g_out, "g_out", final.dtype, final.shape)
    g_rows = torch.zeros((grid.n_tiles, cap, grad_row_width(c)), dtype=final.dtype, device=final.device)
    g_buf0 = torch.empty_like(final)
    kernels.launch(
        "edge_bwd", final.dtype,
        table_tile.data_ptr(), counts.data_ptr(), z_pad.data_ptr(),
        obs_pad.data_ptr() if error_mode else None, final.data_ptr(), g_out.data_ptr(),
        grid.n_tiles, grid.n_tx, grid.tile_h, grid.tile_w, cap, c, int(error_mode),
        g_rows.data_ptr(), g_buf0.data_ptr(),
    )
    return g_rows, g_buf0


class _EdgePass(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table_tile, buffer0, z_pad, obs_pad, counts, grid, error_mode, impl):
        out = edge_fwd(table_tile, buffer0, z_pad, obs_pad, counts, grid, error_mode, impl)
        ctx.save_for_backward(table_tile, out, z_pad, obs_pad, counts)
        ctx.grid, ctx.error_mode, ctx.impl = grid, error_mode, impl
        return out

    @staticmethod
    def backward(ctx, g_out):
        table_tile, final, z_pad, obs_pad, counts = ctx.saved_tensors
        g_rows, g_buf0 = edge_bwd(
            table_tile, final, z_pad, obs_pad, g_out.contiguous(), counts, ctx.grid, ctx.error_mode, ctx.impl
        )
        # widen to the table: only the t and a coefficients are
        # differentiable (band clip, y range, z and active are not)
        c = (table_tile.shape[2] - 25) // 3
        g_table = torch.zeros_like(table_tile)
        g_table[:, :, _E_T : _E_T + 3] = g_rows[:, :, :3]
        g_table[:, :, _E_A : _E_A + 3 * c] = g_rows[:, :, 3:]
        return g_table, g_buf0, None, None, None, None, None, None


def edge_pass(table_tile, buffer0, z_pad, obs_pad, counts, grid: TileGrid, error_mode: bool, impl: str = "kernel"):
    """Differentiable edge pass (gradients to ``table_tile`` and
    ``buffer0``) → blended buffer (nch, H', W')."""
    return _EdgePass.apply(table_tile, buffer0, z_pad, obs_pad, counts, grid, error_mode, impl)
