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
- g_table      (n_tiles, cap, 3D)  [Σ g·x | Σ g·y | Σ g]; rows ≥ count are 0

The TPU kernel's trailing "miss" column of the affine table and its slot
pairing are TPU devices (a one-hot contraction and VLIW latency hiding);
here a miss simply writes 0, and the strict-< update over slots in
ascending order keeps the tie rule: the lowest slot wins.
"""

from __future__ import annotations

import torch

from deodr_tpu_torch.ops import kernels
from deodr_tpu_torch.ops.kernels import TileGrid, from_tiles, tile_coords, to_tiles

_S_YLO, _S_YHI = 0, 2
_S_LEQ, _S_REQ = 4, 10
_S_XLO, _S_XHI = 16, 17
_S_Z = 18
_S_VALID = 21
SETUP_WIDTH = 22


def raster_fwd_reference(setup_tile, affine_tile, counts, grid: TileGrid):
    """Plain version of the forward kernel; differentiable in
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
        row = setup_tile[:, k, :, None, None]  # (nt, 22, 1, 1)
        cov = torch.zeros((nt, th, tw), dtype=torch.bool, device=device)
        for p in range(2):
            la, lb, lc = row[:, _S_LEQ + 3 * p], row[:, _S_LEQ + 3 * p + 1], row[:, _S_LEQ + 3 * p + 2]
            ra, rb, rc = row[:, _S_REQ + 3 * p], row[:, _S_REQ + 3 * p + 1], row[:, _S_REQ + 3 * p + 2]
            row_ok = (yy >= row[:, _S_YLO + p]) & (yy <= row[:, _S_YHI + p])
            plane_l = la * xx + (lb * yy + lc)
            plane_r = ra * xx + (rb * yy + rc)
            cov = cov | (row_ok & (plane_l > 0.0) & (plane_r > neg_tiny))
        cov = cov & (xx >= row[:, _S_XLO]) & (xx <= row[:, _S_XHI])
        z = row[:, _S_Z] * xx + (row[:, _S_Z + 1] * yy + row[:, _S_Z + 2])
        cov = cov & (row[:, _S_VALID] > 0.5) & torch.isfinite(z) & (k < count)[:, None, None]
        better = cov & (z < best_z)
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


def raster_fwd(setup_tile, affine_tile, counts, grid: TileGrid, impl: str = "kernel"):
    """Forward solid pass → (slot_map, z, vals) in the padded layout."""
    if not kernels.use_kernel(affine_tile, impl):
        return raster_fwd_reference(setup_tile, affine_tile, counts, grid)
    kernels.check_float(affine_tile, "affine_tile")
    dtype = affine_tile.dtype
    nt, cap = grid.n_tiles, setup_tile.shape[1]
    d = affine_tile.shape[2] // 3
    kernels.check_tensor(setup_tile, "setup_tile", dtype, (nt, cap, SETUP_WIDTH))
    kernels.check_tensor(affine_tile, "affine_tile", dtype, (nt, cap, 3 * d))
    kernels.check_tensor(counts, "counts", torch.int32, (nt,))
    hp, wp = grid.padded_hw
    dev = affine_tile.device
    slot_map = torch.empty((hp, wp), dtype=torch.int32, device=dev)
    z = torch.empty((hp, wp), dtype=dtype, device=dev)
    vals = torch.empty((d, hp, wp), dtype=dtype, device=dev)
    kernels.launch(
        "raster_fwd", dtype,
        setup_tile.data_ptr(), affine_tile.data_ptr(), counts.data_ptr(),
        nt, grid.n_tx, grid.tile_h, grid.tile_w, cap, d,
        slot_map.data_ptr(), z.data_ptr(), vals.data_ptr(),
    )
    return slot_map, z, vals


def raster_bwd(slot_map, g_vals, counts, grid: TileGrid, cap: int, impl: str = "kernel"):
    """Backward solid pass → g_table (n_tiles, cap, 3D)."""
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
    g_table = torch.zeros((nt, cap, 3 * d), dtype=dtype, device=g_vals.device)
    kernels.launch(
        "raster_bwd", dtype,
        slot_map.data_ptr(), g_vals.data_ptr(), counts.data_ptr(),
        nt, grid.n_tx, grid.tile_h, grid.tile_w, cap, d, g_table.data_ptr(),
    )
    return g_table


class _RasterEval(torch.autograd.Function):
    @staticmethod
    def forward(ctx, affine_tile, setup_tile, counts, grid, impl):
        slot_map, z, vals = raster_fwd(setup_tile, affine_tile, counts, grid, impl)
        ctx.save_for_backward(slot_map, counts)
        ctx.grid, ctx.impl, ctx.cap = grid, impl, affine_tile.shape[1]
        ctx.mark_non_differentiable(slot_map, z)
        return slot_map, z, vals

    @staticmethod
    def backward(ctx, _g_slot, _g_z, g_vals):
        slot_map, counts = ctx.saved_tensors
        g_table = raster_bwd(slot_map, g_vals.contiguous(), counts, ctx.grid, ctx.cap, ctx.impl)
        return g_table, None, None, None, None


def raster_eval(affine_tile, setup_tile, counts, grid: TileGrid, impl: str = "kernel"):
    """Differentiable solid pass (gradient to ``affine_tile`` only) →
    (slot_map, z, vals)."""
    return _RasterEval.apply(affine_tile, setup_tile, counts, grid, impl)
