"""Tiled / binned rasterization: binning, per-tile tables and the glue
around the kernels.

PyTorch counterpart of the tiled path of ``deodr_tpu/ops/tiled.py``
(``rasterize_tiled_pallas``, ``edge_pass_tiled_pallas`` and
``edge_pass_tiled_pallas_tex`` with what they call). The framebuffer is split into fixed-size tiles; triangles are binned
by bounding box and silhouette-edge bands by an exact band-vs-tile test,
each bin a padded per-tile slot list of static capacity in stable item
order. The differentiable per-item rows (affine attribute maps, edge
stencil coefficients) are built here with autograd; the per-pixel loops run
in :mod:`deodr_tpu_torch.ops.kernels`.

Bins that overflow their capacity drop their last entries, as in the JAX
package; ``render_scene(..., check_capacity=True)`` raises instead.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from deodr_tpu_torch.ops.common import bilinear_sample, bilinear_sample_quads, inv3x3, safe_barycentric_matrices
from deodr_tpu_torch.ops.edge_aa import EdgeAAConfig, EdgeData
from deodr_tpu_torch.ops.kernels import TileGrid
from deodr_tpu_torch.ops.kernels.edge_kernel import edge_pass, edge_row_width
from deodr_tpu_torch.ops.kernels.edge_tex_kernel import edge_tex_pass
from deodr_tpu_torch.ops.kernels.raster_kernel import SETUP_WIDTH, raster_eval
from deodr_tpu_torch.ops.raster import TriangleRowSetup, triangle_row_setup


class TilingConfig(NamedTuple):
    """Static tiling parameters: the fields of the JAX package's
    ``TilingConfig`` that this package reads, with the same names and
    defaults. Capacities bound per-tile bin sizes. This package bins
    densely: the two-level (``super_*``) and pair-expansion (``pair_*``)
    binners belong to a later part of the port and raise
    ``NotImplementedError``."""

    tile_h: int = 64
    tile_w: int = 64
    triangle_capacity: int = 64
    edge_capacity: int = 32
    # 0 = no compaction; else drawn (non-culled) triangles are compacted to
    # this static capacity before binning
    drawn_capacity: int = 0
    # tile height of the edge pass (0 = tile_h); edge_capacity is sized for it
    edge_tile_h: int = 0
    # 0 = fetch texels for the whole frame; else the solid pass's texture
    # fetch runs only on the blocks of 8 rows × tex_block_w columns that hold
    # a covered textured pixel, compacted to this static capacity
    tex_tile_capacity: int = 0
    # > 0 (with tex_tile_capacity): fetch per 2×2 screen quad from one 8×8
    # texel window (kernel B4), re-fetching the quads whose taps leave the
    # window per pixel through a compacted list of this capacity
    quad_fallback_capacity: int = 0
    # width of the texture-fetch blocks (0 = tile_w)
    tex_block_w: int = 0
    super_ty: int = 0
    super_tx: int = 0
    super_capacity: int = 0
    pair_ry: int = 0
    pair_rx: int = 0


def _grid(height: int, width: int, tile_h: int, tile_w: int) -> TileGrid:
    return TileGrid(-(-height // tile_h), -(-width // tile_w), tile_h, tile_w)


# ---------------------------------------------------------------- binning


def _compact_index_perm(keep: torch.Tensor, cap: int):
    """Stable front compaction: perm (cap,) int64 listing the kept indices
    in order (0 past the kept count), got (cap,) bool."""
    n = keep.shape[0]
    k = keep.to(torch.int64)
    rank = torch.cumsum(k, 0) - k
    dest = torch.where(keep & (rank < cap), rank, cap)
    perm = torch.zeros(cap + 1, dtype=torch.int64, device=keep.device)
    perm.scatter_(0, dest, torch.arange(n, device=keep.device))
    got = torch.arange(cap, device=keep.device) < k.sum()
    return perm[:cap], got


def _compact_bins(mask: torch.Tensor, capacity: int):
    """Compact a (n_tiles, N) membership mask into per-tile slot lists in
    item order: slots (n_tiles, K) int64 (0 past the count), slot_valid
    (n_tiles, K), counts (n_tiles,), with K = min(capacity, N). An item's
    slot is its prefix count in the tile; ranks ≥ K are dropped."""
    n_tiles, n = mask.shape
    cap = min(capacity, n)
    m = mask.to(torch.int64)
    rank = torch.cumsum(m, 1) - m
    counts = m.sum(1)
    dest = torch.where(mask & (rank < cap), rank, cap)
    slots = torch.zeros((n_tiles, cap + 1), dtype=torch.int64, device=mask.device)
    slots.scatter_(1, dest, torch.arange(n, device=mask.device).expand(n_tiles, n))
    slot_valid = torch.arange(cap, device=mask.device)[None, :] < counts[:, None]
    return slots[:, :cap], slot_valid, counts


def _gather_rows(table: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """``table[slots]`` for an (N, W) table and (n_tiles, K) slot lists →
    (n_tiles, K, W), written as ``index_select``: its backward is one
    ``index_add_`` (atomics on the card), where the backward of plain
    indexing sorts the indices and walks equal ones one after the other,
    and the padding slots of every tile all repeat row 0."""
    return table.index_select(0, slots.reshape(-1)).reshape(slots.shape + (table.shape[1],))


def _bin_to_tiles(x_lo, x_hi, y_lo, y_hi, valid, grid: TileGrid, capacity: int):
    """Bin items, given clamped pixel bboxes, to the tiles they overlap."""
    def tile_of(v, size):
        return torch.div(v.to(torch.int64), size, rounding_mode="floor")

    tx0, tx1 = tile_of(x_lo, grid.tile_w), tile_of(x_hi, grid.tile_w)
    ty0, ty1 = tile_of(y_lo, grid.tile_h), tile_of(y_hi, grid.tile_h)
    nonempty = valid & (x_lo <= x_hi) & (y_lo <= y_hi)
    dev = x_lo.device
    tys = torch.arange(grid.n_ty, device=dev)[:, None, None]
    txs = torch.arange(grid.n_tx, device=dev)[None, :, None]
    mask = nonempty & (tys >= ty0) & (tys <= ty1) & (txs >= tx0) & (txs <= tx1)  # (n_ty, n_tx, N)
    return _compact_bins(mask.reshape(grid.n_tiles, -1), capacity)


def _occupancy_counts(x_lo, x_hi, y_lo, y_hi, ok, n_ty, n_tx, th, tw):
    """(n_ty, n_tx) number of the ``ok`` pixel boxes that overlap each tile,
    by a 2-D difference array."""
    def tile(v, size, n):
        return torch.nan_to_num(torch.div(v, size, rounding_mode="floor"), nan=0.0).clamp(0, n - 1).long()

    ty0, ty1 = tile(y_lo, th, n_ty), tile(y_hi, th, n_ty)
    tx0, tx1 = tile(x_lo, tw, n_tx), tile(x_hi, tw, n_tx)
    okl = ok.long()
    # scatter_add_ (integer atomics): index_put_(accumulate=True) sorts and
    # walks equal indices one after the other on the card, and most boxes
    # fall in a few tiles
    delta = torch.zeros((n_ty + 1) * (n_tx + 1), dtype=torch.int64, device=ok.device)
    for ys, xs, w in ((ty0, tx0, okl), (ty1 + 1, tx0, -okl), (ty0, tx1 + 1, -okl), (ty1 + 1, tx1 + 1, okl)):
        delta.scatter_add_(0, ys * (n_tx + 1) + xs, w)
    return delta.reshape(n_ty + 1, n_tx + 1).cumsum(0).cumsum(1)[:n_ty, :n_tx]


def _bin_boxes(tiling: TilingConfig, x_lo, x_hi, y_lo, y_hi, valid, grid: TileGrid, capacity: int):
    """Dense bbox binning; the large-mesh binners are not ported yet."""
    if tiling.pair_ry and tiling.pair_rx:
        raise NotImplementedError("pair-expansion binning (pair_ry/pair_rx) comes with the large-mesh binning slice")
    if tiling.super_capacity and (grid.n_ty > tiling.super_ty or grid.n_tx > tiling.super_tx):
        raise NotImplementedError("two-level binning (super_capacity) comes with the large-mesh binning slice")
    return _bin_to_tiles(x_lo, x_hi, y_lo, y_hi, valid, grid, capacity)


def _occlusion_keep_mask(edge_z, z_buffer, grid: TileGrid):
    """(n_tiles, E) bool: can an edge band blend any pixel of the tile?
    The band's depth lies between its endpoint depths and the blend is
    z-tested with strict <, so a band whose nearest endpoint is not in front
    of the tile's farthest z-buffer entry is culled; a relative slack keeps
    the cull conservative. Padding pixels count as -inf (never keep)."""
    h, w = z_buffer.shape
    hp, wp = grid.padded_hw
    zp = F.pad(z_buffer.detach(), (0, wp - w, 0, hp - h), value=-math.inf)
    tile_z_max = zp.reshape(grid.n_ty, grid.tile_h, grid.n_tx, grid.tile_w).amax(dim=(1, 3)).reshape(-1)
    z_near = edge_z.detach().amin(dim=1)
    slack = 1e-3 * (1.0 + z_near.abs())
    return (z_near - slack)[None, :] < tile_z_max[:, None]


def _edge_band_tile_mask(v0, v1, sigma, active, grid: TileGrid, height, width, margin=1.0):
    """(n_tiles, E) bool: does edge e's antialiasing band (the parallelogram
    spanned by the edge and its normal × sigma) meet tile t? Exact
    separating-axis test over the band's two axes and the tile's two,
    conservative by ``margin`` pixels and winding-agnostic."""
    dtype, dev = v0.dtype, v0.device
    tile_h, tile_w = grid.tile_h, grid.tile_w
    d = v1 - v0
    n = torch.stack([d[:, 1], -d[:, 0]], dim=1)
    c0 = n[:, 0] * v0[:, 0] + n[:, 1] * v0[:, 1]
    half = torch.sqrt(n[:, 0] * n[:, 0] + n[:, 1] * n[:, 1]) * (sigma + margin)
    b_lo_n, b_hi_n = c0 - half, c0 + half
    p0 = d[:, 0] * v0[:, 0] + d[:, 1] * v0[:, 1]
    p1 = d[:, 0] * v1[:, 0] + d[:, 1] * v1[:, 1]
    dl = torch.sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1])
    b_lo_d = torch.minimum(p0, p1) - dl * margin
    b_hi_d = torch.maximum(p0, p1) + dl * margin

    tys = torch.arange(grid.n_ty, dtype=dtype, device=dev)
    txs = torch.arange(grid.n_tx, dtype=dtype, device=dev)
    gx0 = txs * tile_w - margin
    gx1 = torch.clamp_max(txs * tile_w + tile_w - 1, width - 1) + margin
    gy0 = tys * tile_h - margin
    gy1 = torch.clamp_max(tys * tile_h + tile_h - 1, height - 1) + margin

    ex_lo = torch.minimum(v0[:, 0], v1[:, 0]) - (sigma + margin)
    ex_hi = torch.maximum(v0[:, 0], v1[:, 0]) + (sigma + margin)
    ey_lo = torch.minimum(v0[:, 1], v1[:, 1]) - (sigma + margin)
    ey_hi = torch.maximum(v0[:, 1], v1[:, 1]) + (sigma + margin)
    ok_x = (gx0[None, :, None] <= ex_hi) & (gx1[None, :, None] >= ex_lo)  # (1, n_tx, E)
    ok_y = (gy0[:, None, None] <= ey_hi) & (gy1[:, None, None] >= ey_lo)  # (n_ty, 1, E)

    def rect_proj(ax, ay):
        # min/max over the tile corners of ax·x + ay·y, separably
        px0, px1 = ax[None, :] * gx0[:, None], ax[None, :] * gx1[:, None]  # (n_tx, E)
        py0, py1 = ay[None, :] * gy0[:, None], ay[None, :] * gy1[:, None]  # (n_ty, E)
        return torch.minimum(px0, px1), torch.maximum(px0, px1), torch.minimum(py0, py1), torch.maximum(py0, py1)

    nx_lo, nx_hi, ny_lo, ny_hi = rect_proj(n[:, 0], n[:, 1])
    ok_n = (nx_lo[None] + ny_lo[:, None] <= b_hi_n) & (nx_hi[None] + ny_hi[:, None] >= b_lo_n)
    dx_lo, dx_hi, dy_lo, dy_hi = rect_proj(d[:, 0], d[:, 1])
    ok_d = (dx_lo[None] + dy_lo[:, None] <= b_hi_d) & (dx_hi[None] + dy_hi[:, None] >= b_lo_d)
    mask = ok_x & ok_y & ok_n & ok_d & active
    return mask.reshape(grid.n_tiles, -1)


def suggest_tiling(
    ij,
    faces,
    height: int,
    width: int,
    sigma: float = 0.0,
    edgeflags=None,
    tile_h: int = None,
    tile_w: int = 64,
    margin: float = 1.5,
    for_pallas: bool = False,
    bucket_mode: str = "pow2",
) -> TilingConfig:
    """Estimate per-tile bin occupancies of the given projected geometry
    (numpy arrays, on the host) and return a TilingConfig whose capacities
    hold them, with the JAX package's rules: the same tile shape choice
    (``for_pallas`` forces 128-wide tiles; big triangles get 48-row
    tiles), the same margin and bucketing. Triangle occupancy counts
    bounding boxes with a 2-D difference array; edge occupancy uses the
    edge pass's own band-vs-tile test."""
    ij = np.asarray(ij)
    faces = np.asarray(faces)
    if for_pallas:
        tile_w = 128
    if tile_h is None:
        tri_h = ij[faces][:, :, 1]
        med_h = float(np.median(tri_h.max(axis=1) - tri_h.min(axis=1))) if len(faces) else 32.0
        if med_h <= 12:
            tile_h = 8
        elif med_h <= 32:
            tile_h = 16 if for_pallas else 32
        else:
            tile_h = 48 if for_pallas else 64
        tile_h = min(tile_h, max(8, height))
    grid = _grid(height, width, tile_h, tile_w)

    def occupancy(x_lo, x_hi, y_lo, y_hi, gh, gw, gny, gnx):
        tx0 = np.clip(x_lo // gw, 0, gnx - 1).astype(int)
        tx1 = np.clip(x_hi // gw, 0, gnx - 1).astype(int)
        ty0 = np.clip(y_lo // gh, 0, gny - 1).astype(int)
        ty1 = np.clip(y_hi // gh, 0, gny - 1).astype(int)
        ok = (x_lo <= x_hi) & (y_lo <= y_hi)
        delta = np.zeros((gny + 1, gnx + 1))
        np.add.at(delta, (ty0[ok], tx0[ok]), 1)
        np.add.at(delta, (ty1[ok] + 1, tx0[ok]), -1)
        np.add.at(delta, (ty0[ok], tx1[ok] + 1), -1)
        np.add.at(delta, (ty1[ok] + 1, tx1[ok] + 1), 1)
        counts = np.cumsum(np.cumsum(delta, axis=0), axis=1)[:gny, :gnx]
        return int(counts.max()) if counts.size else 0

    tri = ij[faces]
    x_lo = np.clip(np.floor(tri[:, :, 0].min(axis=1)), 0, width - 1)
    x_hi = np.clip(np.floor(tri[:, :, 0].max(axis=1)), 0, width - 1)
    y_lo = np.clip(np.floor(tri[:, :, 1].min(axis=1)), 0, height - 1)
    y_hi = np.clip(np.floor(tri[:, :, 1].max(axis=1)), 0, height - 1)
    tri_cap = occupancy(x_lo, x_hi, y_lo, y_hi, tile_h, tile_w, grid.n_ty, grid.n_tx)

    edge_cap = 8
    if sigma > 0 and edgeflags is not None and np.any(edgeflags):
        flat = np.asarray(edgeflags).reshape(-1)
        tri_ids = np.repeat(np.arange(len(faces)), 3)[flat]
        slot = np.tile(np.arange(3), len(faces))[flat]
        p0 = torch.from_numpy(ij[faces[tri_ids, np.array([1, 2, 0])[slot]]].astype(np.float32))
        p1 = torch.from_numpy(ij[faces[tri_ids, np.array([0, 1, 2])[slot]]].astype(np.float32))
        mask = _edge_band_tile_mask(
            p0, p1, float(sigma), torch.ones(len(p0), dtype=torch.bool), grid, height, width
        )
        edge_cap = int(mask.sum(dim=1).max()) if mask.numel() else 0

    def bucket(n):
        n = max(1, int(math.ceil(n * margin)))
        if bucket_mode == "exact":
            return max(8, -(-n // 8) * 8)
        return max(8, int(2 ** math.ceil(math.log2(n))))

    super_ty = super_tx = super_capacity = 0
    if grid.n_tiles * max(len(faces), 1) > (1 << 22):
        super_ty, super_tx = 8, 4
        s_occ = occupancy(
            x_lo, x_hi, y_lo, y_hi, tile_h * super_ty, tile_w * super_tx,
            -(-grid.n_ty // super_ty), -(-grid.n_tx // super_tx),
        )
        super_capacity = bucket(max(s_occ, 8))

    return TilingConfig(
        tile_h=tile_h,
        tile_w=tile_w,
        triangle_capacity=bucket(tri_cap),
        edge_capacity=bucket(edge_cap),
        super_ty=super_ty,
        super_tx=super_tx,
        super_capacity=super_capacity,
    )


# ------------------------------------------------------------- solid pass


class RasterTables(NamedTuple):
    """Inputs of the solid-pass kernels (see raster_kernel's layouts)."""

    affine_tile: torch.Tensor  # (n_tiles, cap, 3D), differentiable
    setup_tile: torch.Tensor  # (n_tiles, cap, 22)
    counts: torch.Tensor  # (n_tiles,) int32
    grid: TileGrid


def _pack_setup_rows(setup: TriangleRowSetup, dtype, strict_edge: bool = True) -> torch.Tensor:
    """(T, 22) setup rows. For ``strict_edge`` the left/right edge
    equations are sign-normalized so coverage is ``plane > 0`` (left,
    strict) and ``plane ≥ 0`` (right): a left equation with a ≤ 0 and a
    right one with a > 0 are negated, which encodes the rational x-range
    rule, den == 0 included. Non-strict rows keep the equations as they
    are: their kernel mode evaluates the rational range itself."""
    leq, req = setup.left_eq, setup.right_eq
    if strict_edge:
        leq = torch.where(leq[:, :, 0:1] > 0, leq, -leq)
        req = torch.where(req[:, :, 0:1] > 0, -req, req)
    cols = [
        setup.y_lo[:, 0:1], setup.y_lo[:, 1:2], setup.y_hi[:, 0:1], setup.y_hi[:, 1:2],
        leq[:, 0, :], leq[:, 1, :], req[:, 0, :], req[:, 1, :],
        setup.x_lo[:, None], setup.x_hi[:, None], setup.z_coef, setup.valid[:, None],
    ]
    return torch.cat([c.to(dtype) for c in cols], dim=1)


def _affine_attribute_maps(scene, v_xy, v_z, faces, faces_uv, textured, shaded) -> torch.Tensor:
    """Differentiable per-triangle affine attribute maps (T, D, 3),
    A(x, y) = corner values · bary(x, y), with the attribute order
    [colors (C) | uv (2) | shade (1)][| 1/z][| textured flag] (uv, shade
    and the flag only for a scene with a texture, the flag row the constant
    0 or 1; 1/z only for a perspective-correct scene, whose corner values
    are divided by their depth). Gradients reach vertex positions through
    the barycentric matrix, colors, uv and shade through the corners, and
    the depths through 1/z."""
    xy1_to_bary, _ = safe_barycentric_matrices(v_xy)  # (T, 3, 3)
    corner = scene.colors[faces]  # (T, 3, C)
    if scene.texture is not None:
        corner = torch.cat([corner, scene.uv[faces_uv], scene.shade[faces][..., None]], dim=-1)
    if scene.perspective_correct:
        inv_z = 1.0 / v_z
        corner = torch.cat([corner / v_z[..., None], inv_z[..., None]], dim=-1)
    affine = (
        corner[:, 0, :, None] * xy1_to_bary[:, 0, None, :]
        + corner[:, 1, :, None] * xy1_to_bary[:, 1, None, :]
        + corner[:, 2, :, None] * xy1_to_bary[:, 2, None, :]
    )
    if scene.texture is not None:
        flag_row = torch.zeros((affine.shape[0], 1, 3), dtype=affine.dtype, device=affine.device)
        flag_row[:, 0, 2] = (textured & shaded).to(affine.dtype)
        affine = torch.cat([affine, flag_row], dim=1)
    return affine


def _finish_shading(scene, vals, z_buffer, background, tex_px=None):
    """Perspective recovery, texture fetch and background compositing;
    vals (H, W, D) in the attribute order of :func:`_affine_attribute_maps`
    (a perspective-correct scene's values are multiplied by 1 / (1/z) where
    a triangle covers the pixel; the JAX package divides by 0 elsewhere, and
    its gradients turn NaN).
    Without ``tex_px`` (the shaded texture samples, (H, W, C)) the fetch
    runs on the full frame (pixels that no textured triangle covers sample
    at uv = 0 and are not selected); :func:`_finish_shading_tile_tex` is the
    block-compacted one."""
    c = scene.colors.shape[1]
    pix = vals[..., :c]
    big_z = None
    if scene.perspective_correct:
        inv_z = vals[..., vals.shape[-1] - (2 if scene.texture is not None else 1), None]
        # an uncovered pixel holds 0 there: 1/0 would turn its (masked-out) cotangent into 0 · ∞ = NaN
        big_z = 1.0 / torch.where(torch.isfinite(z_buffer)[..., None], inv_z, 1.0)
        pix = pix * big_z
    if scene.texture is not None:
        if tex_px is None:
            uv_px, lum = vals[..., c : c + 2], vals[..., c + 2 : c + 3]
            if big_z is not None:
                uv_px, lum = uv_px * big_z, lum * big_z
            tex_px = bilinear_sample(scene.texture, uv_px) * lum
        use_tex = vals[..., -1].detach() > 0.5
        pix = torch.where(use_tex[..., None], tex_px, pix)
    pix = torch.where(torch.isfinite(pix), pix, 0.0)
    return torch.where(torch.isfinite(z_buffer)[..., None], pix, background)


def raster_tables(scene, ij_off, draw, tiling: TilingConfig, checks=None):
    """Bin the drawn triangles and gather the solid kernel's per-tile
    tables."""
    height, width = scene.height, scene.width
    grid = _grid(height, width, tiling.tile_h, tiling.tile_w)
    dtype = ij_off.dtype
    faces, faces_uv, textured, shaded = scene.faces, scene.faces_uv, scene.textured, scene.shaded
    if tiling.drawn_capacity:
        # index-level compaction of the drawn triangles: every later cost
        # scales with their number
        dcap = min(tiling.drawn_capacity, faces.shape[0])
        if checks is not None:
            checks.append(("drawn-triangle compaction", draw.sum(), dcap))
        perm, got = _compact_index_perm(draw, dcap)
        faces, faces_uv, textured, shaded = faces[perm], faces_uv[perm], textured[perm], shaded[perm]
        draw = draw[perm] & got
    v_xy = ij_off[faces]  # (T, 3, 2)
    v_z = scene.depths[faces]
    setup = triangle_row_setup(v_xy.detach(), v_z.detach(), draw, width, height, scene.strict_edge,
                               scene.perspective_correct)
    slots, slot_valid, counts = _bin_boxes(
        tiling, setup.x_lo, setup.x_hi, setup.y_lo[:, 0], setup.y_hi[:, 1], setup.valid,
        grid, tiling.triangle_capacity,
    )
    setup_tile = _gather_rows(_pack_setup_rows(setup, dtype, scene.strict_edge), slots)  # (n_tiles, cap, 22)
    setup_tile[:, :, SETUP_WIDTH - 1] *= slot_valid.to(dtype)
    affine = _affine_attribute_maps(scene, v_xy, v_z, faces, faces_uv, textured, shaded)  # (T, D, 3)
    # kernel layout [x-coeffs D | y-coeffs D | const D]
    affine_g = affine.transpose(1, 2).reshape(affine.shape[0], 3 * affine.shape[1])
    affine_tile = _gather_rows(affine_g, slots)  # (n_tiles, cap, 3D)
    return RasterTables(affine_tile, setup_tile, counts.to(torch.int32), grid)


def _finish_shading_tile_tex(scene, vals_pad, tiling: TilingConfig, grid: TileGrid, z_buffer, background, impl,
                             checks=None):
    """:func:`_finish_shading` with a block-compacted texture fetch: the
    fetch runs only on the blocks of 8 rows × ``tex_block_w`` (or
    ``tile_w``) columns that hold a covered textured pixel (by the textured
    flag plane of the solid pass), compacted in order to
    ``tex_tile_capacity`` slots ("texture tile compaction"), and its
    samples are added back into the frame. With ``quad_fallback_capacity``
    the blocks are fetched per 2×2 screen quad
    (:func:`deodr_tpu_torch.ops.common.bilinear_sample_quads`). While the
    capacities hold, the image equals the full-frame fetch's."""
    bw = tiling.tex_block_w or tiling.tile_w
    hp, wp = grid.padded_hw
    if hp % 8 or wp % bw:
        raise ValueError(f"texture-fetch blocks of 8×{bw} must tile the {hp}×{wp} padded frame")
    n_by, n_bx = hp // 8, wp // bw
    n_blocks = n_by * n_bx
    k_cap = min(tiling.tex_tile_capacity, n_blocks)
    c = scene.colors.shape[1]
    d = vals_pad.shape[0]

    def blocks(planes):  # (k, H', W') → (n_blocks, k, 8, bw)
        k = planes.shape[0]
        return planes.reshape(k, n_by, 8, n_bx, bw).permute(1, 3, 0, 2, 4).reshape(n_blocks, k, 8, bw)

    flag = blocks(vals_pad[d - 1 : d].detach() > 0.5)[:, 0]  # (n_blocks, 8, bw)
    occupied = flag.reshape(n_blocks, -1).any(dim=1)
    if checks is not None:
        checks.append(("texture tile compaction", occupied.sum(), k_cap))
    tids, tvalid, _ = _compact_bins(occupied[None, :], k_cap)
    tids, tvalid = tids[0], tvalid[0]
    sel = blocks(vals_pad[c : c + 3]).reshape(n_blocks, 3 * 8 * bw).index_select(0, tids).reshape(k_cap, 3, 8, bw)
    uv_px = torch.stack([sel[:, 0], sel[:, 1]], dim=-1)  # (K, 8, bw, 2)
    lum = sel[:, 2]
    tex_h, tex_w = scene.texture.shape[0], scene.texture.shape[1]
    if tiling.quad_fallback_capacity and bw % 2 == 0 and tex_h % 2 == 0 and tex_w % 2 == 0 and min(tex_h, tex_w) >= 8:

        def to_quads(a):  # (K, 8, bw, ...) → (K·4·bw/2, 4, ...), pixel 2·dy + dx of each quad
            rest = a.shape[3:]
            a = a.reshape((k_cap, 4, 2, bw // 2, 2) + rest).transpose(2, 3)
            return a.reshape((k_cap * 4 * (bw // 2), 4) + rest)

        samples = bilinear_sample_quads(scene.texture, to_quads(uv_px), to_quads(flag.index_select(0, tids)),
                                        tiling.quad_fallback_capacity, checks, impl)
        samples = samples.reshape(k_cap, 4, bw // 2, 2, 2, c).transpose(2, 3).reshape(k_cap, 8, bw, c)
        tex_px = samples * lum[..., None]
    else:
        tex_px = bilinear_sample(scene.texture, uv_px) * lum[..., None]
    tex_px = torch.where(torch.isfinite(tex_px), tex_px, 0.0)
    # invalid slots point at block 0: zero their rows so that adding them changes nothing
    tex_rows = (tex_px * tvalid[:, None, None, None].to(tex_px.dtype)).reshape(k_cap, 8 * bw * c)
    full = tex_rows.new_zeros((n_blocks, 8 * bw * c)).index_add(0, tids, tex_rows)
    tex_full = full.reshape(n_by, n_bx, 8, bw, c).transpose(1, 2).reshape(hp, wp, c)[: scene.height, : scene.width]
    vals = vals_pad.permute(1, 2, 0)[: scene.height, : scene.width, :]
    return _finish_shading(scene, vals, z_buffer, background, tex_full)


def rasterize_tiled_kernel(scene, ij_off, draw, background, tiling: TilingConfig, impl="kernel", checks=None):
    """Tiled solid pass through the raster kernel → (image (H, W, C),
    z_buffer (H, W), max bin count). Counterpart of
    ``rasterize_tiled_pallas``. A perspective-correct scene fetches its
    texels on the full frame (the block-compacted fetch reads affine uv), as
    there."""
    tables = raster_tables(scene, ij_off, draw, tiling, checks)
    _, z_pad, vals_pad = raster_eval(tables.affine_tile, tables.setup_tile, tables.counts, tables.grid, impl,
                                     scene.strict_edge, scene.perspective_correct)
    height, width = scene.height, scene.width
    z_buffer = z_pad[:height, :width]
    if scene.texture is not None and tiling.tex_tile_capacity and not scene.perspective_correct:
        image = _finish_shading_tile_tex(scene, vals_pad, tiling, tables.grid, z_buffer, background, impl, checks)
    else:
        vals = vals_pad.permute(1, 2, 0)[:height, :width, :]
        image = _finish_shading(scene, vals, z_buffer, background)
    return image, z_buffer, tables.counts.max()


# -------------------------------------------------------------- edge pass


class EdgeTables(NamedTuple):
    """Inputs of the edge-pass kernels (see edge_kernel's and
    edge_tex_kernel's layouts)."""

    table_tile: torch.Tensor  # (n_tiles, cap, 25 + 3C, or 35 + 3C with a texture), differentiable
    counts: torch.Tensor  # (n_tiles,) int32
    grid: TileGrid


def _transform_ineq_rows(b0c, b1c, tc, dtype):
    """The four band-clip inequality rows as uniform ``plane > θ`` tests:
    for a row (a, b, c), keep p > 0 when a > 0, p ≥ 0 (θ = −min_normal)
    when a < 0, and by sign flip b·y + c < 0 when a == 0 — the rational
    x-range rule of the reference at the predicate level. Not
    differentiable (a pixel-set decision). Returns (rows (E, 12),
    thetas (E, 4))."""
    tiny = torch.finfo(dtype).tiny
    neg_tc = torch.cat([-tc[:, 0:2], 1.0 - tc[:, 2:3]], dim=1)
    rows, thetas = [], []
    for r3 in (b0c, b1c, tc, neg_tc):
        r3 = r3.detach()
        a = r3[:, 0]
        rows.append(torch.where((a == 0)[:, None], -r3, r3))
        thetas.append(torch.where(a < 0, -tiny, 0.0).to(dtype))
    return torch.cat(rows, dim=1), torch.stack(thetas, dim=1)


def _edge_stencil_rows(cfg: EdgeAAConfig, edges: EdgeData, height: int):
    """Differentiable per-edge stencil rows (b0c, b1c, tc, y_beg, y_end,
    zcoef, active) from the inverse of [[v0 v1 n], [1 1 0]]. Degenerate
    edges (shorter than the float noise floor) get a harmless dummy edge so
    no inf/NaN reaches the backward, and are made inactive."""
    sigma = cfg.sigma
    v0 = edges.v0
    eps_d = torch.finfo(v0.dtype).eps
    sq = v0 * v0 + edges.v1 * edges.v1
    scale2 = torch.clamp_min(sq[:, 0] + sq[:, 1], 1.0)
    dv = edges.v1 - v0
    degenerate = ~(dv[:, 0] * dv[:, 0] + dv[:, 1] * dv[:, 1] > (100.0 * eps_d) ** 2 * scale2)
    unit_x = torch.eye(1, 2, dtype=v0.dtype, device=v0.device)  # [[1, 0]], made on the device
    v1 = torch.where(degenerate[:, None], v0 + unit_x, edges.v1)
    if cfg.clockwise:
        n = torch.stack([v0[:, 1] - v1[:, 1], v1[:, 0] - v0[:, 0]], dim=1)
    else:
        n = torch.stack([v1[:, 1] - v0[:, 1], v0[:, 0] - v1[:, 0]], dim=1)
    n = n / torch.sqrt(n[:, 0:1] * n[:, 0:1] + n[:, 1:2] * n[:, 1:2])
    ones = torch.ones_like(v0[:, 0])
    m = torch.stack(
        [
            torch.stack([v0[:, 0], v1[:, 0], n[:, 0]], dim=1),
            torch.stack([v0[:, 1], v1[:, 1], n[:, 1]], dim=1),
            torch.stack([ones, ones, torch.zeros_like(ones)], dim=1),
        ],
        dim=1,
    )  # (E, 3, 3)
    inv = inv3x3(m)
    b0c, b1c = inv[:, 0, :], inv[:, 1, :]
    tc = inv[:, 2, :] / sigma
    vy_min = torch.minimum(v0[:, 1], v1[:, 1]).detach()
    vy_max = torch.maximum(v0[:, 1], v1[:, 1]).detach()
    y_beg = torch.clamp_min(torch.floor(vy_min - sigma) + 1, 0.0)
    y_end = torch.clamp_max(torch.floor(vy_max + sigma), float(height - 1))
    finite = torch.isfinite(inv).all(dim=2).all(dim=1)
    active = edges.active & finite & ~degenerate
    zcoef = (b0c * edges.z[:, 0:1] + b1c * edges.z[:, 1:2]).detach()
    return b0c, b1c, tc, y_beg, y_end, zcoef, active


def edge_tables(cfg: EdgeAAConfig, edges: EdgeData, z_buffer, tiling: TilingConfig) -> EdgeTables:
    """Build the edge rows (colors and depth, and with ``cfg.has_texture``
    also uv and shade, folded into affine (x, y) coefficients,
    differentiably) and bin the bands to tiles, culling bands hidden behind
    the tile's z-buffer."""
    height, width = cfg.height, cfg.width
    grid = _grid(height, width, tiling.edge_tile_h or tiling.tile_h, tiling.tile_w)
    dtype = edges.v0.dtype
    c = edges.attrs.shape[-1]
    b0c, b1c, tc, y_beg, y_end, zcoef, active = _edge_stencil_rows(cfg, edges, height)
    a0, a1 = edges.attrs[:, 0, :], edges.attrs[:, 1, :]
    acoef = b0c[:, None, :] * a0[:, :, None] + b1c[:, None, :] * a1[:, :, None]  # (E, C, 3)
    i14, th14 = _transform_ineq_rows(b0c, b1c, tc, dtype)
    cols = [i14, th14, tc, y_beg[:, None], y_end[:, None], acoef.reshape(acoef.shape[0], 3 * c), zcoef,
            active.to(dtype)[:, None]]
    act_col = edge_row_width(c) - 1
    if cfg.has_texture:
        ucoef = b0c * edges.uvs[:, 0, 0:1] + b1c * edges.uvs[:, 1, 0:1]  # (E, 3)
        vcoef = b0c * edges.uvs[:, 0, 1:2] + b1c * edges.uvs[:, 1, 1:2]
        lcoef = b0c * edges.shades[:, 0:1] + b1c * edges.shades[:, 1:2]
        cols += [ucoef, vcoef, lcoef, edges.use_texture.to(dtype)[:, None]]
    rows = torch.cat(cols, dim=1)
    mask = _edge_band_tile_mask(edges.v0.detach(), edges.v1.detach(), cfg.sigma, active, grid, height, width)
    mask = mask & _occlusion_keep_mask(edges.z, z_buffer, grid)
    slots, slot_valid, counts = _compact_bins(mask, tiling.edge_capacity)
    table_tile = _gather_rows(rows, slots)  # (n_tiles, cap, W)
    table_tile = torch.cat(
        [table_tile[..., :act_col], table_tile[..., act_col : act_col + 1] * slot_valid[..., None],
         table_tile[..., act_col + 1 :]],
        dim=-1,
    )
    return EdgeTables(table_tile, counts.to(torch.int32), grid)


def pad_edge_buffers(cfg: EdgeAAConfig, buffer, z_buffer, obs, grid: TileGrid):
    """Planar padded views (buf (nch, H', W'), z (H', W') padded with +inf,
    obs (C, H', W') in error mode, else None)."""
    hp, wp = grid.padded_hw
    pad = (0, wp - cfg.width, 0, hp - cfg.height)
    if cfg.error_mode:
        buf_pad = F.pad(buffer, pad)[None]
        obs_pad = F.pad(obs.permute(2, 0, 1), pad).contiguous()
    else:
        buf_pad = F.pad(buffer.permute(2, 0, 1), pad)
        obs_pad = None
    z_pad = F.pad(z_buffer.detach(), pad, value=math.inf)
    return buf_pad.contiguous(), z_pad.contiguous(), obs_pad


def edge_pass_tiled_kernel(cfg: EdgeAAConfig, buffer, edges: EdgeData, z_buffer, obs, tiling: TilingConfig,
                           impl="kernel"):
    """Tiled edge-overdraw pass through the edge kernel → (buffer,
    max bin count). Counterpart of ``edge_pass_tiled_pallas``."""
    tables = edge_tables(cfg, edges, z_buffer, tiling)
    buf_pad, z_pad, obs_pad = pad_edge_buffers(cfg, buffer, z_buffer, obs, tables.grid)
    out_pad = edge_pass(tables.table_tile, buf_pad, z_pad, obs_pad, tables.counts, tables.grid, cfg.error_mode, impl)
    h, w = cfg.height, cfg.width
    out = out_pad[0, :h, :w] if cfg.error_mode else out_pad.permute(1, 2, 0)[:h, :w, :]
    return out, tables.counts.max()


# ----------------------------------------------------- textured edge pass


class EdgeTexPlan(NamedTuple):
    """Static plan of the textured edge pass, with the JAX package's field
    names. Edges whose uv span exceeds ``uv_segment_length`` texels are
    split into at most ``n_split`` collinear segments and the active
    segments compacted to ``seg_capacity`` slots (0 = no compaction);
    splitting a band lengthwise is exact, since the transparency ramp is a
    line distance and every attribute is affine along the edge. On the TPU
    the split bounds each segment's texture window; this package reads
    texels directly, has no window fields, and keeps the split only so that
    slot lists and blend order are the JAX package's."""

    n_split: int = 1
    seg_capacity: int = 0
    uv_segment_length: float = 12.0


def split_edges(edges: EdgeData, n_split: int, segment_length=None, uv_segment_length=None) -> EdgeData:
    """Chop each edge into up to ``n_split`` collinear segments of roughly
    ``segment_length`` pixels and/or ``uv_segment_length`` texels (the
    Chebyshev span of the edge's uv segment); the extra segments of short
    edges are inactive. Segments are edge-major, so the depth order across
    edges is kept. Segment endpoints at t = 0 and t = 1 reuse the original
    endpoint values bit for bit, so an unsplit edge is unchanged."""
    e = edges.v0.shape[0]
    dtype, dev = edges.v0.dtype, edges.v0.device
    need = torch.ones(e, dtype=dtype, device=dev)
    if segment_length is not None:
        d = edges.v1 - edges.v0
        need = torch.maximum(need, torch.sqrt((d * d).sum(dim=1)) / segment_length)
    if uv_segment_length is not None:
        uvlen = (edges.uvs[:, 1] - edges.uvs[:, 0]).abs().amax(dim=1)
        need = torch.maximum(need, uvlen / uv_segment_length)
    n_seg = torch.nan_to_num(need.detach(), nan=1.0, posinf=float(n_split)).ceil().clamp(1, n_split)  # (E,)
    ks = torch.arange(n_split, dtype=dtype, device=dev)  # (S,)
    t0 = (ks[None, :] / n_seg[:, None]).clamp_max(1.0)[..., None]  # (E, S, 1)
    t1 = ((ks[None, :] + 1) / n_seg[:, None]).clamp_max(1.0)[..., None]
    seg_active = (ks[None, :] < n_seg[:, None]) & edges.active[:, None]

    c = edges.attrs.shape[-1]
    # endpoint columns [v (2) | z (1) | attrs (C) | uv (2) | shade (1)]
    cat0 = torch.cat([edges.v0, edges.z[:, 0:1], edges.attrs[:, 0], edges.uvs[:, 0], edges.shades[:, 0:1]], dim=1)
    cat1 = torch.cat([edges.v1, edges.z[:, 1:2], edges.attrs[:, 1], edges.uvs[:, 1], edges.shades[:, 1:2]], dim=1)
    a0, a1 = cat0[:, None, :], cat1[:, None, :]

    def lerp(t):
        return torch.where(t == 0.0, a0, torch.where(t == 1.0, a1, a0 + t * (a1 - a0))).reshape(e * n_split, -1)

    s0, s1 = lerp(t0), lerp(t1)
    return EdgeData(
        v0=s0[:, 0:2],
        v1=s1[:, 0:2],
        z=torch.stack([s0[:, 2], s1[:, 2]], dim=1),
        attrs=torch.stack([s0[:, 3 : 3 + c], s1[:, 3 : 3 + c]], dim=1),
        uvs=torch.stack([s0[:, 3 + c : 5 + c], s1[:, 3 + c : 5 + c]], dim=1),
        shades=torch.stack([s0[:, 5 + c], s1[:, 5 + c]], dim=1),
        active=seg_active.reshape(-1),
        use_texture=edges.use_texture.repeat_interleave(n_split),
    )


def compact_active_edges(edges: EdgeData, capacity: int) -> EdgeData:
    """Compact the active edges or segments to the front, in order, into
    min(capacity, E) slots; the slots past the active count repeat edge 0
    and are inactive."""
    cap = min(capacity, edges.active.shape[0])
    perm, got = _compact_index_perm(edges.active, cap)
    return EdgeData(
        v0=edges.v0[perm],
        v1=edges.v1[perm],
        z=edges.z[perm],
        attrs=edges.attrs[perm],
        uvs=edges.uvs[perm],
        shades=edges.shades[perm],
        active=edges.active[perm] & got,
        use_texture=edges.use_texture[perm],
    )


def edge_pass_tiled_kernel_tex(cfg: EdgeAAConfig, buffer, edges: EdgeData, texture, z_buffer, obs,
                               tiling: TilingConfig, tex_plan: EdgeTexPlan, impl="kernel", checks=None):
    """Tiled edge-overdraw pass of a textured or mixed scene through the
    textured edge kernel → (buffer, max bin count). Counterpart of
    ``edge_pass_tiled_pallas_tex``: the same split, compaction, rows and
    bins, without the per-edge texture windows (see
    :mod:`deodr_tpu_torch.ops.kernels.edge_tex_kernel`)."""
    if tex_plan.n_split > 1:
        edges = split_edges(edges, tex_plan.n_split, None, uv_segment_length=tex_plan.uv_segment_length)
        if tex_plan.seg_capacity:
            if checks is not None:
                checks.append(("texture-window segment compaction", edges.active.sum(), tex_plan.seg_capacity))
            edges = compact_active_edges(edges, tex_plan.seg_capacity)
    tables = edge_tables(cfg, edges, z_buffer, tiling)
    buf_pad, z_pad, obs_pad = pad_edge_buffers(cfg, buffer, z_buffer, obs, tables.grid)
    out_pad = edge_tex_pass(
        tables.table_tile, texture, buf_pad, z_pad, obs_pad, tables.counts, tables.grid, cfg.error_mode, impl
    )
    h, w = cfg.height, cfg.width
    out = out_pad[0, :h, :w] if cfg.error_mode else out_pad.permute(1, 2, 0)[:h, :w, :]
    return out, tables.counts.max()
