"""Tiled solid pass: z-argmin winner per pixel and the winner's affine
attribute planes, forward and backward.

Counterpart of ``deodr_tpu/ops/pallas/raster_kernel.py`` (``_fwd_kernel``,
``_bwd_kernel`` under the ``raster_eval_pallas`` custom VJP). On a CUDA
tensor the wrappers launch the kernels of ``csrc/raster_kernel.cu``; on a
CPU tensor, or with ``impl="reference"``, they run the plain PyTorch
versions below, which loop over slots in the kernel's order and evaluate
every predicate plane with the kernel's operation order, so the two agree
bit for bit on which pixels are covered.

Layouts (one row per slot, the natural result of gathering table rows):

- setup_tile   (n_tiles, cap, 22)  non-differentiable per-slot scalars
- affine_tile  (n_tiles, cap, 3D)  [x-coeffs D | y-coeffs D | const D]
- counts       (n_tiles,) int32    slots used per tile
- slot_map     (H', W') int32      winning slot, ``cap`` where nothing covers
- z            (H', W')            winning depth, +inf where nothing covers
- vals         (D, H', W')         winner's A(x, y), 0 where nothing covers
- g_table      (n_tiles, cap, 3D)  [Σ g·x | Σ g·y | Σ g]; rows ≥ count are 0,
                                   every entry written by the kernel

The TPU kernel's trailing "miss" column of the affine table and its slot
pairing are TPU devices (a one-hot contraction and VLIW latency hiding);
here a miss simply writes 0, and the strict-< update over slots in
ascending order keeps the tie rule: the lowest slot wins.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from deodr_tpu_torch.ops import kernels
from deodr_tpu_torch.ops.common import ceil_div, floor_div
from deodr_tpu_torch.ops.kernels import TileGrid, from_tiles, tile_coords, to_tiles

_S_YLO, _S_YHI = 0, 2
_S_LEQ, _S_REQ = 4, 10
_S_XLO, _S_XHI = 16, 17
_S_Z = 18
_S_VALID = 21
SETUP_WIDTH = 22
# shared memory one block can use on the H100 (227 KB), and the largest portable thread-block cluster
MAX_SMEM_BYTES = 232_448
MAX_CLUSTER = 8
RASTER_BWD_THREADS = 256
# pixels a lane of the forward kernel holds (kRasterFwdPixels in csrc/raster_kernel.cu)
RASTER_FWD_PIXELS = 1


class RasterBwdShape(NamedTuple):
    """Launch shape of the backward kernel: each tile's pixels are shared by
    one cluster of ``blocks_per_tile`` blocks of ``threads`` threads (a
    block loops when the cluster has fewer threads than the tile has
    pixels), and every block holds a ``smem_bytes`` accumulator."""

    threads: int
    blocks_per_tile: int
    smem_bytes: int


def raster_bwd_launch_shape(tile_h: int, tile_w: int, cap: int, d: int, itemsize: int) -> RasterBwdShape:
    """Threads per block (256, fewer on a tile of fewer pixels), blocks per
    tile (the cluster size, at most 8; a block loops over the pixels beyond
    8 × 256) and shared bytes per block (a cap × 3D accumulator) of the
    backward kernel; raises ``ValueError`` where the accumulator does not fit
    a block's shared memory."""
    smem = cap * 3 * d * itemsize
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"raster_bwd: cap={cap} slots × 3·D={3 * d} values × {itemsize} bytes = {smem} bytes of "
                         f"shared memory, above the {MAX_SMEM_BYTES} bytes a block can use")
    n_px = tile_h * tile_w
    threads = min(RASTER_BWD_THREADS, max(32, -(-n_px // 32) * 32))
    return RasterBwdShape(threads, max(1, min(MAX_CLUSTER, -(-n_px // threads))), smem)


def raster_fwd_launch_shape(tile_h: int, tile_w: int, itemsize: int) -> kernels.FwdShape:
    """Launch shape of the forward kernel (:func:`kernels.fwd_launch_shape`):
    the tile's warp regions at ``RASTER_FWD_PIXELS`` pixels a lane over
    independent blocks of up to 256 threads, two 64-row chunks of setup rows
    in shared memory."""
    return kernels.fwd_launch_shape(tile_h, tile_w, RASTER_FWD_PIXELS, SETUP_WIDTH, itemsize)


def _coverage(row, yy, xx, neg_tiny, strict=True, persp=False):
    """The forward's coverage predicate and depth of setup rows ``row``
    (..., 22, 1, 1) at pixels (yy, xx), in the kernel's operation order.
    ``strict``: the sign-normalised edge planes, left > 0 and right > −tiny
    (``_pack_setup_rows``); else the rows' own edge equations with the
    rational x range of ``_coverage_and_z``'s non-strict mode, per pixel row.
    ``persp``: the depth is 1 / plane, and a pixel where it is not finite is
    not covered."""
    def r(j):
        return row[..., j, :, :]

    def plane(j):
        return r(j) * xx + (r(j + 1) * yy + r(j + 2))

    x_lo, x_hi = r(_S_XLO), r(_S_XHI)
    cov = None
    for p in range(2):
        row_ok = (yy >= r(_S_YLO + p)) & (yy <= r(_S_YHI + p))
        le, re = _S_LEQ + 3 * p, _S_REQ + 3 * p
        if strict:
            ok = row_ok & (plane(le) > 0.0) & (plane(re) > neg_tiny)
        else:
            t_l = ceil_div(-(r(le + 1) * yy + r(le + 2)), r(le), x_lo - 1, x_hi)
            t_r = floor_div(-(r(re + 1) * yy + r(re + 2)), r(re), x_lo - 1, x_hi)
            ok = row_ok & (xx >= torch.maximum(x_lo, t_l)) & (xx <= torch.minimum(x_hi, t_r))
        cov = ok if cov is None else cov | ok
    if strict:
        cov = cov & (xx >= x_lo) & (xx <= x_hi)
    z = plane(_S_Z)
    if persp:
        z = 1.0 / z
    return cov & (r(_S_VALID) > 0.5) & torch.isfinite(z), z


def covered_visits(setup_tile, counts, grid: TileGrid, strict: bool = True, persp: bool = False) -> int:
    """Number of (pixel, slot) pairs at which a slot's row covers the pixel
    (the coverage predicate of :func:`raster_fwd_reference`): the pairs whose
    coverage test has to be made pixel by pixel. Every other pair fails on
    a rectangle around the pixel too, where the kernel rejects it for many
    pixels at once."""
    nt, cap, _ = setup_tile.shape
    yy, xx = tile_coords(grid, setup_tile.dtype, setup_tile.device)
    count = counts.to(torch.int64).clamp(max=cap)
    neg_tiny = -torch.finfo(setup_tile.dtype).tiny
    n = torch.zeros((), dtype=torch.int64, device=setup_tile.device)
    for k in range(int(count.max()) if nt else 0):
        cov, _ = _coverage(setup_tile[:, k, :, None, None], yy, xx, neg_tiny, strict, persp)
        n += (cov & (k < count)[:, None, None]).sum()
    return int(n)


def raster_may_cover(rows, x0, x1, y0, y1, strict=True):
    """Plain mirror of ``raster_may_cover`` (csrc/raster_kernel.cu), the
    forward kernel's region cull: whether a setup row may cover a pixel of
    the rectangle [x0, x1] × [y0, y1], false only where no pixel there passes
    the validity, x-range, y-range and (``strict``) edge-plane tests. The
    rectangle is clipped to the row's x range and each sub-triangle's y
    range, and each plane is evaluated in the kernel's operation order at
    the clipped rectangle's corner that maximises it. Non-strict rows are
    not sign-normalised, so their cull keeps the validity, x-range and
    y-range tests only (a superset of what their rational ranges cover).
    ``rows`` (..., 22) broadcasts against the rectangle's bounds (...)."""
    neg_tiny = -torch.finfo(rows.dtype).tiny
    x_lo, x_hi = rows[..., _S_XLO], rows[..., _S_XHI]
    may_row = (rows[..., _S_VALID] > 0.5) & (x1 >= x_lo) & (x0 <= x_hi)
    cx0, cx1 = torch.fmax(x0, x_lo), torch.fmin(x1, x_hi)
    may = torch.zeros_like(may_row)
    for p in range(2):
        y_lo, y_hi = rows[..., _S_YLO + p], rows[..., _S_YHI + p]
        cy0, cy1 = torch.fmax(y0, y_lo), torch.fmin(y1, y_hi)
        ok = (y1 >= y_lo) & (y0 <= y_hi)
        for j, threshold in ((_S_LEQ + 3 * p, 0.0), (_S_REQ + 3 * p, neg_tiny)) if strict else ():
            a, b, c = rows[..., j], rows[..., j + 1], rows[..., j + 2]
            x = torch.where(a >= 0, cx1, cx0)
            y = torch.where(b >= 0, cy1, cy0)
            ok = ok & (a * x + (b * y + c) > threshold)
        may = may | ok
    return may_row & may


def region_cull(setup_tile, counts, grid: TileGrid, strict: bool = True):
    """(n_tiles, regions, cap) bool: the (warp region, slot) pairs that the
    forward kernel's cull (:func:`raster_may_cover`) keeps."""
    def may_cover(rows, x0, x1, y0, y1):
        return raster_may_cover(rows, x0, x1, y0, y1, strict)

    return kernels.region_cull(may_cover, setup_tile, counts, grid, RASTER_FWD_PIXELS)


def raster_fwd_reference(setup_tile, affine_tile, counts, grid: TileGrid, strict: bool = True, persp: bool = False):
    """Plain version of the forward kernel in the coverage mode ``strict``
    and depth mode ``persp`` (see :func:`_coverage`); differentiable in
    ``affine_tile`` by autograd."""
    nt, cap, _ = setup_tile.shape
    d = affine_tile.shape[2] // 3
    dtype, device = affine_tile.dtype, affine_tile.device
    th, tw = grid.tile_h, grid.tile_w
    yy, xx = tile_coords(grid, dtype, device)  # (nt, th, 1), (nt, 1, tw)
    count = counts.to(torch.int64).clamp(max=cap)
    neg_tiny = -torch.finfo(dtype).tiny
    best_z = torch.full((nt, th, tw), float("inf"), dtype=dtype, device=device)
    best = torch.full((nt, th, tw), cap, dtype=torch.int32, device=device)
    n_iter = int(count.max()) if nt else 0
    for k in range(n_iter):
        cov, z = _coverage(setup_tile[:, k, :, None, None], yy, xx, neg_tiny, strict, persp)
        better = cov & (k < count)[:, None, None] & (z < best_z)
        best_z = torch.where(better, z, best_z)
        best = torch.where(better, k, best)

    # the winner's attribute planes, evaluated once after the loop
    n_px = th * tw
    if cap > 0:
        idx = best.to(torch.int64).clamp(max=cap - 1).reshape(nt, n_px, 1).expand(nt, n_px, 3 * d)
        rows = torch.gather(affine_tile, 1, idx)  # (nt, P, 3D)
        x_px = xx.expand(nt, th, tw).reshape(nt, n_px, 1)
        y_px = yy.expand(nt, th, tw).reshape(nt, n_px, 1)
        v = rows[..., :d] * x_px + (rows[..., d : 2 * d] * y_px + rows[..., 2 * d :])
        v = torch.where((best < cap).reshape(nt, n_px, 1), v, 0.0)
    else:
        v = torch.zeros((nt, n_px, d), dtype=dtype, device=device)
    vals = v.transpose(1, 2).reshape(nt, d, th, tw)
    return from_tiles(best, grid), from_tiles(best_z, grid), from_tiles(vals, grid)


def raster_bwd_reference(slot_map, g_vals, counts, grid: TileGrid, cap: int):
    """Plain version of the backward kernel: per slot, the pixel
    cotangents it owns reduced against (x, y, 1)."""
    d = g_vals.shape[0]
    dtype, device = g_vals.dtype, g_vals.device
    slot_t = to_tiles(slot_map, grid)  # (nt, th, tw)
    g_t = to_tiles(g_vals, grid)  # (nt, D, th, tw)
    yy, xx = tile_coords(grid, dtype, device)
    nt = grid.n_tiles
    count = counts.to(torch.int64).clamp(max=cap)
    g_table = torch.zeros((nt, cap, 3 * d), dtype=dtype, device=device)
    n_iter = int(count.max()) if nt else 0
    for k in range(n_iter):
        mask = (slot_t == k) & (k < count)[:, None, None]
        gm = torch.where(mask[:, None], g_t, 0.0)  # (nt, D, th, tw)
        g_table[:, k, :d] = (gm * xx[:, None]).sum(dim=(2, 3))
        g_table[:, k, d : 2 * d] = (gm * yy[:, None]).sum(dim=(2, 3))
        g_table[:, k, 2 * d :] = gm.sum(dim=(2, 3))
    return g_table


def raster_fwd(setup_tile, affine_tile, counts, grid: TileGrid, impl: str = "kernel", strict: bool = True,
               persp: bool = False):
    """Forward solid pass → (slot_map, z, vals) in the padded layout, in the
    coverage mode ``strict`` (sign-normalised setup rows, else the rational
    non-strict range) and the depth mode ``persp`` (z = 1 / plane); the
    kernel is launched in the shape of :func:`raster_fwd_launch_shape`."""
    if not kernels.use_kernel(affine_tile, impl):
        return raster_fwd_reference(setup_tile, affine_tile, counts, grid, strict, persp)
    kernels.check_float(affine_tile, "affine_tile")
    dtype = affine_tile.dtype
    nt, cap = grid.n_tiles, setup_tile.shape[1]
    d = affine_tile.shape[2] // 3
    kernels.check_tensor(setup_tile, "setup_tile", dtype, (nt, cap, SETUP_WIDTH))
    kernels.check_tensor(affine_tile, "affine_tile", dtype, (nt, cap, 3 * d))
    kernels.check_tensor(counts, "counts", torch.int32, (nt,))
    shape = raster_fwd_launch_shape(grid.tile_h, grid.tile_w, affine_tile.element_size())
    hp, wp = grid.padded_hw
    dev = affine_tile.device
    slot_map = torch.empty((hp, wp), dtype=torch.int32, device=dev)
    z = torch.empty((hp, wp), dtype=dtype, device=dev)
    vals = torch.empty((d, hp, wp), dtype=dtype, device=dev)
    kernels.launch(
        "raster_fwd", dtype,
        setup_tile.data_ptr(), affine_tile.data_ptr(), counts.data_ptr(),
        nt, grid.n_tx, grid.tile_h, grid.tile_w, cap, d, int(strict), int(persp), *shape,
        slot_map.data_ptr(), z.data_ptr(), vals.data_ptr(),
    )
    return slot_map, z, vals


def raster_bwd(slot_map, g_vals, counts, grid: TileGrid, cap: int, impl: str = "kernel"):
    """Backward solid pass → g_table (n_tiles, cap, 3D), launched in the
    shape of :func:`raster_bwd_launch_shape`."""
    if not kernels.use_kernel(g_vals, impl):
        return raster_bwd_reference(slot_map, g_vals, counts, grid, cap)
    kernels.check_float(g_vals, "g_vals")
    dtype = g_vals.dtype
    nt = grid.n_tiles
    d = g_vals.shape[0]
    hp, wp = grid.padded_hw
    kernels.check_tensor(slot_map, "slot_map", torch.int32, (hp, wp))
    kernels.check_tensor(g_vals, "g_vals", dtype, (d, hp, wp))
    kernels.check_tensor(counts, "counts", torch.int32, (nt,))
    shape = raster_bwd_launch_shape(grid.tile_h, grid.tile_w, cap, d, g_vals.element_size())
    g_table = torch.empty((nt, cap, 3 * d), dtype=dtype, device=g_vals.device)  # the kernel writes every entry
    kernels.launch(
        "raster_bwd", dtype,
        slot_map.data_ptr(), g_vals.data_ptr(), counts.data_ptr(),
        nt, grid.n_tx, grid.tile_h, grid.tile_w, cap, d, shape.threads, shape.blocks_per_tile, g_table.data_ptr(),
    )
    return g_table


class _RasterEval(torch.autograd.Function):
    @staticmethod
    def forward(ctx, affine_tile, setup_tile, counts, grid, impl, strict, persp):
        slot_map, z, vals = raster_fwd(setup_tile, affine_tile, counts, grid, impl, strict, persp)
        ctx.save_for_backward(slot_map, counts)
        ctx.grid, ctx.impl, ctx.cap = grid, impl, affine_tile.shape[1]
        ctx.mark_non_differentiable(slot_map, z)
        return slot_map, z, vals

    @staticmethod
    def backward(ctx, _g_slot, _g_z, g_vals):
        slot_map, counts = ctx.saved_tensors
        g_table = raster_bwd(slot_map, g_vals.contiguous(), counts, ctx.grid, ctx.cap, ctx.impl)
        return g_table, None, None, None, None, None, None


def raster_eval(affine_tile, setup_tile, counts, grid: TileGrid, impl: str = "kernel", strict: bool = True,
                persp: bool = False):
    """Differentiable solid pass (gradient to ``affine_tile`` only) →
    (slot_map, z, vals), in the modes of :func:`raster_fwd`. The backward
    reads the slot map alone, so both modes share it."""
    return _RasterEval.apply(affine_tile, setup_tile, counts, grid, impl, strict, persp)
