"""Tiled silhouette edge-overdraw pass for textured and mixed scenes,
forward and backward.

Counterpart of ``deodr_tpu/ops/pallas/edge_tex_kernel.py`` (``_fwd_kernel``,
``_bwd_kernel`` under the ``edge_pass_pallas_tex`` custom VJP). The painter's
loop is the untextured one of :mod:`.edge_kernel`; what differs is the band
colour of a slot::

    plain slot      A = a·(x, y, 1)                       per channel
    textured slot   A = sample(u, v) · lum,   u = uc·(x, y, 1),
                    v = vc·(x, y, 1), lum = lc·(x, y, 1)

with ``sample`` the bilinear fetch of :func:`deodr_tpu_torch.ops.common.
bilinear_taps` against the full texture. The TPU kernel samples per-edge
texture windows with one-hot matrix products because a TPU has no vector
gather; here the taps are read from the texture itself and the texel
gradients are accumulated into a texture-shaped buffer (atomics in the CUDA
kernel, ``index_add_`` in the plain version). Where a TPU window would not
cover a tap the TPU kernel clamps into the window; this one reads the true
texel.

On a CUDA tensor the wrappers launch ``csrc/edge_tex_kernel.cu``; on a CPU
tensor, or with ``impl="reference"``, they run the plain versions below,
which evaluate every plane, and the sample, in the kernel's operation order.

Edge-table row layout (width 35 + 3·C): the untextured row of
:mod:`.edge_kernel` followed by

  [uc (3) | vc (3) | lc (3) | use_tex]

(the TPU row's window origin and window id columns have no use here).

Gradient rows (n_tiles, cap, 12 + 3·C):

  [g_t (3) | g_a (3 per channel) | g_uc (3) | g_vc (3) | g_lc (3)]

each as (Σ g·x, Σ g·y, Σ g); a textured slot leaves its g_a columns 0, a
plain slot its g_uc, g_vc, g_lc columns, and rows ≥ count are 0, every
entry written by the kernel.
"""

from __future__ import annotations

import torch

from deodr_tpu_torch.ops import kernels
from deodr_tpu_torch.ops.common import bilinear_blend, bilinear_taps
from deodr_tpu_torch.ops.kernels import TileGrid, from_tiles, tile_coords, to_tiles
from deodr_tpu_torch.ops.kernels.edge_kernel import (
    _E_A,
    _E_T,
    _band_mask_and_t,
    _plane,
    _sq_residual,
    _unblend,
    band_may_cover,
    edge_bwd_launch_shape,
    edge_row_width,
)

_TEX_EXTRA = 10
# pixels a lane of the forward kernel holds (kTexFwdPixels in csrc/edge_tex_kernel.cu)
TEX_FWD_PIXELS = 1


def tex_row_width(nb_colors: int) -> int:
    return edge_row_width(nb_colors) + _TEX_EXTRA


def tex_grad_row_width(nb_colors: int) -> int:
    return 12 + 3 * nb_colors


def edge_tex_fwd_launch_shape(tile_h: int, tile_w: int, nb_colors: int, itemsize: int) -> kernels.FwdShape:
    """Launch shape of ``edge_tex_fwd`` (:func:`kernels.fwd_launch_shape`):
    the tile's warp regions at ``TEX_FWD_PIXELS`` pixels a lane over
    independent blocks of up to 256 threads, two 64-row chunks of the
    textured table in shared memory."""
    return kernels.fwd_launch_shape(tile_h, tile_w, TEX_FWD_PIXELS, tex_row_width(nb_colors), itemsize)


def region_cull(table_tile, counts, grid: TileGrid):
    """(n_tiles, regions, cap) bool: the (warp region, slot) pairs that the
    forward kernel's cull keeps: :func:`.edge_kernel.band_may_cover` on the
    band planes, which the textured row keeps in the untextured row's
    columns, at ``TEX_FWD_PIXELS`` pixels a lane."""
    return kernels.region_cull(band_may_cover, table_tile, counts, grid, TEX_FWD_PIXELS)


def _e_uc(nb_colors: int) -> int:
    return edge_row_width(nb_colors)


def _e_vc(nb_colors: int) -> int:
    return edge_row_width(nb_colors) + 3


def _e_lc(nb_colors: int) -> int:
    return edge_row_width(nb_colors) + 6


def _e_utex(nb_colors: int) -> int:
    return edge_row_width(nb_colors) + 9


def _nb_colors(table_tile) -> int:
    return (table_tile.shape[2] - 25 - _TEX_EXTRA) // 3


def _slot_footprint(row, texture, yy, xx, mask, c):
    """Texture footprint and shade plane of one slot per tile. The
    coordinates and the shade are zeroed off the band mask, so that whatever
    an inactive, plain or dummy row carries there (NaN included) never
    becomes a texel index, nor a NaN cotangent of the sample (0 · NaN)."""
    u = torch.where(mask, _plane(row, _e_uc(c), yy, xx), 0.0)
    v = torch.where(mask, _plane(row, _e_vc(c), yy, xx), 0.0)
    lum = torch.where(mask, _plane(row, _e_lc(c), yy, xx), 0.0)
    eu, ev, idx, taps = bilinear_taps(texture, u, v)
    return u, v, lum, eu, ev, idx, taps


def _band_colors(row, use_tex, sample, lum, mask, yy, xx, c):
    """Band colour planes of one slot per tile (sample · shade for a
    textured slot, its affine planes for a plain one), 0 off the band mask:
    like the kernel, nothing reads a row's planes where it does not paint."""
    return [torch.where(mask, torch.where(use_tex, sample[..., ch] * lum, _plane(row, _E_A + 3 * ch, yy, xx)), 0.0)
            for ch in range(c)]


def textured_visits(table_tile, z_pad, counts, grid: TileGrid) -> int:
    """Number of (pixel, slot) pairs at which a textured slot paints: each
    is one 4-tap fetch of the forward and one 4-tap scatter of the
    backward."""
    nt, cap, _ = table_tile.shape
    c = _nb_colors(table_tile)
    yy, xx = tile_coords(grid, z_pad.dtype, z_pad.device)
    zb = to_tiles(z_pad, grid)
    count = counts.to(torch.int64).clamp(max=cap)
    n = 0
    for k in range(int(count.max()) if nt else 0):
        row = table_tile[:, k, :, None, None]
        mask, _ = _band_mask_and_t(row, yy, xx, zb, c)
        n += int((mask & (k < count)[:, None, None] & (row[:, _e_utex(c)] > 0.5)).sum())
    return n


def edge_tex_fwd_reference(table_tile, texture, buffer0, z_pad, obs_pad, counts, grid: TileGrid, error_mode: bool):
    """Plain version of the forward kernel; differentiable in
    ``table_tile``, ``texture`` and ``buffer0`` by autograd."""
    nt, cap, _ = table_tile.shape
    c = _nb_colors(table_tile)
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
        use_tex = row[:, _e_utex(c)] > 0.5
        _, _, lum, eu, ev, _, taps = _slot_footprint(row, texture, yy, xx, mask & use_tex, c)
        sample = bilinear_blend(eu[..., None], ev[..., None], taps)  # (nt, th, tw, C)
        a = _band_colors(row, use_tex, sample, lum, mask, yy, xx, c)
        if error_mode:
            a = [_sq_residual(a, obs_t)]
        bufs = [torch.where(mask, a[ch] + t * (bufs[ch] - a[ch]), bufs[ch]) for ch in range(len(bufs))]
    return from_tiles(torch.stack(bufs, dim=1), grid)


def edge_tex_bwd_reference(table_tile, texture, final, z_pad, obs_pad, g_out, counts, grid: TileGrid,
                           error_mode: bool):
    """Plain version of the backward kernel → (g_rows (n_tiles, cap,
    12 + 3C), g_buf0 like ``final``, g_texture like ``texture``)."""
    nt, cap, _ = table_tile.shape
    c = _nb_colors(table_tile)
    th_tex, tw_tex, _ = texture.shape
    dtype, device = final.dtype, final.device
    yy, xx = tile_coords(grid, dtype, device)
    zb = to_tiles(z_pad, grid)
    obs_t = to_tiles(obs_pad, grid) if error_mode else None
    bufs = list(to_tiles(final, grid).unbind(1))
    gbufs = list(to_tiles(g_out, grid).unbind(1))
    count = counts.to(torch.int64).clamp(max=cap)
    g_rows = torch.zeros((nt, cap, tex_grad_row_width(c)), dtype=dtype, device=device)
    g_tex = torch.zeros((th_tex * tw_tex, c), dtype=dtype, device=device)
    n_iter = int(count.max()) if nt else 0
    for k in reversed(range(n_iter)):
        row = table_tile[:, k, :, None, None]
        mask, t = _band_mask_and_t(row, yy, xx, zb, c)
        mask = mask & (k < count)[:, None, None]
        use_tex = row[:, _e_utex(c)] > 0.5
        tex_mask = mask & use_tex
        u, v, lum, eu, ev, idx, (t00, t10, t01, t11) = _slot_footprint(row, texture, yy, xx, tex_mask, c)
        eu_c, ev_c = eu[..., None], ev[..., None]
        top = (1 - eu_c) * t00 + eu_c * t10
        bot = (1 - eu_c) * t01 + eu_c * t11
        sample = top * (1 - ev_c) + bot * ev_c
        a = _band_colors(row, use_tex, sample, lum, mask, yy, xx, c)

        g_t, g_as, bufs, gbufs = _unblend(mask, t, a, bufs, gbufs, obs_t, error_mode)

        # the textured slots' share: shade, texels and (u, v), the latter
        # gated to 0 where the coordinate was clamped at a border
        g_a = torch.stack([torch.where(tex_mask, g, 0.0) for g in g_as], dim=-1)  # (nt, th, tw, C)
        g_lum = (g_a * sample).sum(dim=-1)
        g_s = g_a * lum[..., None]
        d_u = (t10 - t00) * (1 - ev_c) + (t11 - t01) * ev_c
        d_v = bot - top
        fu, fv = torch.floor(u), torch.floor(v)
        g_u = torch.where((fu >= 0) & (fu <= tw_tex - 2), (g_s * d_u).sum(dim=-1), 0.0)
        g_v = torch.where((fv >= 0) & (fv <= th_tex - 2), (g_s * d_v).sum(dim=-1), 0.0)
        sel = tex_mask.reshape(-1)
        flat_idx = idx.reshape(-1)[sel]
        for off, w in ((0, (1 - eu_c) * (1 - ev_c)), (1, eu_c * (1 - ev_c)), (tw_tex, (1 - eu_c) * ev_c),
                       (tw_tex + 1, eu_c * ev_c)):
            g_tex.index_add_(0, flat_idx + off, (g_s * w).reshape(-1, c)[sel])

        plain = ~use_tex
        quantities = [g_t] + [torch.where(plain, g, 0.0) for g in g_as] + [g_u, g_v, g_lum]
        for q, g in enumerate(quantities):
            g_rows[:, k, 3 * q] = (g * xx).sum(dim=(1, 2))
            g_rows[:, k, 3 * q + 1] = (g * yy).sum(dim=(1, 2))
            g_rows[:, k, 3 * q + 2] = g.sum(dim=(1, 2))
    g_buf0 = from_tiles(torch.stack(gbufs, dim=1), grid)
    return g_rows, g_buf0, g_tex.reshape(texture.shape)


def _check_inputs(table_tile, texture, buf, z_pad, obs_pad, counts, grid, error_mode):
    kernels.check_float(buf, "buffer")
    dtype = buf.dtype
    nt, cap, w = table_tile.shape
    c = _nb_colors(table_tile)
    if w != tex_row_width(c) or not 1 <= c <= 4:
        raise ValueError(f"table_tile: row width {w} is not 35 + 3·C for C in 1..4")
    if texture.ndim != 3 or texture.shape[0] < 2 or texture.shape[1] < 2:
        raise ValueError(f"texture: expected (th ≥ 2, tw ≥ 2, C), got {tuple(texture.shape)}")
    if texture.shape[0] * texture.shape[1] * c >= 2**31:
        raise ValueError("texture: the kernel indexes texels with 32-bit integers")
    hp, wp = grid.padded_hw
    kernels.check_tensor(table_tile, "table_tile", dtype, (grid.n_tiles, cap, w))
    kernels.check_tensor(texture, "texture", dtype, (texture.shape[0], texture.shape[1], c))
    kernels.check_tensor(buf, "buffer", dtype, (1 if error_mode else c, hp, wp))
    kernels.check_tensor(z_pad, "z_pad", dtype, (hp, wp))
    if error_mode:
        kernels.check_tensor(obs_pad, "obs_pad", dtype, (c, hp, wp))
    kernels.check_tensor(counts, "counts", torch.int32, (grid.n_tiles,))
    return c, cap


def edge_tex_fwd(table_tile, texture, buffer0, z_pad, obs_pad, counts, grid: TileGrid, error_mode: bool,
                 impl: str = "kernel"):
    """Forward textured edge pass → blended buffer (nch, H', W');
    ``texture`` is (th, tw, C) and ``obs_pad`` (C, H', W') is read in error
    mode only (may be None otherwise). The kernel is launched in the shape
    of :func:`edge_tex_fwd_launch_shape`."""
    if not kernels.use_kernel(buffer0, impl):
        return edge_tex_fwd_reference(table_tile, texture, buffer0, z_pad, obs_pad, counts, grid, error_mode)
    c, cap = _check_inputs(table_tile, texture, buffer0, z_pad, obs_pad, counts, grid, error_mode)
    shape = edge_tex_fwd_launch_shape(grid.tile_h, grid.tile_w, c, buffer0.element_size())
    out = torch.empty_like(buffer0)
    kernels.launch(
        "edge_tex_fwd", buffer0.dtype,
        table_tile.data_ptr(), counts.data_ptr(), z_pad.data_ptr(),
        obs_pad.data_ptr() if error_mode else None, texture.data_ptr(), buffer0.data_ptr(),
        grid.n_tiles, grid.n_tx, grid.tile_h, grid.tile_w, cap, c, int(error_mode),
        texture.shape[0], texture.shape[1], *shape, out.data_ptr(),
    )
    return out


def edge_tex_bwd(table_tile, texture, final, z_pad, obs_pad, g_out, counts, grid: TileGrid, error_mode: bool,
                 impl: str = "kernel"):
    """Backward textured edge pass → (g_rows (n_tiles, cap, 12 + 3C),
    g_buf0, g_texture), launched in the shape of
    :func:`.edge_kernel.edge_bwd_launch_shape`."""
    if not kernels.use_kernel(final, impl):
        return edge_tex_bwd_reference(table_tile, texture, final, z_pad, obs_pad, g_out, counts, grid, error_mode)
    c, cap = _check_inputs(table_tile, texture, final, z_pad, obs_pad, counts, grid, error_mode)
    kernels.check_tensor(g_out, "g_out", final.dtype, final.shape)
    shape = edge_bwd_launch_shape(grid.tile_h, grid.tile_w, c, True, final.element_size())
    # the kernel writes every entry of g_rows (rows ≥ count as 0) and adds into g_tex
    g_rows = torch.empty((grid.n_tiles, cap, tex_grad_row_width(c)), dtype=final.dtype, device=final.device)
    g_buf0 = torch.empty_like(final)
    g_tex = torch.zeros_like(texture)
    kernels.launch(
        "edge_tex_bwd", final.dtype,
        table_tile.data_ptr(), counts.data_ptr(), z_pad.data_ptr(),
        obs_pad.data_ptr() if error_mode else None, texture.data_ptr(), final.data_ptr(), g_out.data_ptr(),
        grid.n_tiles, grid.n_tx, grid.tile_h, grid.tile_w, cap, c, int(error_mode),
        texture.shape[0], texture.shape[1], *shape, g_rows.data_ptr(), g_buf0.data_ptr(), g_tex.data_ptr(),
    )
    return g_rows, g_buf0, g_tex


class _EdgeTexPass(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table_tile, texture, buffer0, z_pad, obs_pad, counts, grid, error_mode, impl):
        texture = texture.contiguous()
        out = edge_tex_fwd(table_tile, texture, buffer0, z_pad, obs_pad, counts, grid, error_mode, impl)
        ctx.save_for_backward(table_tile, texture, out, z_pad, obs_pad, counts)
        ctx.grid, ctx.error_mode, ctx.impl = grid, error_mode, impl
        return out

    @staticmethod
    def backward(ctx, g_out):
        table_tile, texture, final, z_pad, obs_pad, counts = ctx.saved_tensors
        g_rows, g_buf0, g_tex = edge_tex_bwd(
            table_tile, texture, final, z_pad, obs_pad, g_out.contiguous(), counts, ctx.grid, ctx.error_mode, ctx.impl
        )
        # widen to the table: the t, a, uc, vc and lc coefficients are
        # differentiable (band clip, y range, z and the flags are not)
        c = _nb_colors(table_tile)
        g_table = torch.zeros_like(table_tile)
        g_table[:, :, _E_T : _E_T + 3] = g_rows[:, :, :3]
        g_table[:, :, _E_A : _E_A + 3 * c] = g_rows[:, :, 3 : 3 + 3 * c]
        g_table[:, :, _e_uc(c) : _e_uc(c) + 9] = g_rows[:, :, 3 + 3 * c :]
        return g_table, g_tex, g_buf0, None, None, None, None, None, None


def edge_tex_pass(table_tile, texture, buffer0, z_pad, obs_pad, counts, grid: TileGrid, error_mode: bool,
                  impl: str = "kernel"):
    """Differentiable textured edge pass (gradients to ``table_tile``,
    ``texture`` and ``buffer0``) → blended buffer (nch, H', W')."""
    return _EdgeTexPass.apply(table_tile, texture, buffer0, z_pad, obs_pad, counts, grid, error_mode, impl)
