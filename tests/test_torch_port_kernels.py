"""The port's kernel modules (deodr_tpu_torch.ops.kernels) on the CPU, where
each wrapper runs its plain PyTorch version:

- against the JAX package's Pallas kernels in interpret mode on identical
  float32 tables (forward outputs and vjp cotangents), with the tolerances
  of tests/test_pallas_kernels.py; slot_map must match exactly;
- each plain backward against autograd through its plain forward, in
  float64, to 1e-9 relative;
- the forward kernels' region culls: their plain mirrors never drop a
  (region, slot) pair that covers a pixel, B1f's covered-pair count against
  the JAX coverage predicate, and the forward launch shapes;
- B1's non-strict and perspective modes (plain version, covered pairs and
  cull) against the Pallas kernel in those modes.

The CUDA kernels themselves are held against these plain versions on the
card (tests/test_torch_port_cuda.py and chip_smoke.py).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deodr_tpu.ops.pallas.edge_kernel import PallasEdgeConfig, edge_pass_pallas
from deodr_tpu.ops.pallas.raster_kernel import PallasRasterConfig, raster_eval_pallas
from deodr_tpu_torch.ops.edge_aa import EdgeAAConfig
from deodr_tpu_torch.ops.kernels import edge_kernel as ek
from deodr_tpu_torch.ops.kernels import raster_kernel as rk
from deodr_tpu_torch.ops.render import _build_edge_data, prepare, scene_buffers_from_numpy
from deodr_tpu_torch.ops.tiled import (
    TilingConfig,
    edge_tables,
    pad_edge_buffers,
    raster_tables,
    rasterize_tiled_kernel,
)
from examples.triangle_soup_fitting import create_example_scene

SIZE = (96, 128)


def _fields(n_tri=15, seed=4):
    """Untextured triangle soup as numpy SceneBuffers fields."""
    np.random.seed(seed)
    scene2d = create_example_scene(n_tri=n_tri, width=SIZE[1], height=SIZE[0], textured_ratio=0.0)
    base = dataclasses.replace(scene2d._buffers(*scene2d._diff_inputs()), texture=None)
    return {
        f.name: np.asarray(v) if hasattr(v, "shape") else v
        for f in dataclasses.fields(base)
        for v in [getattr(base, f.name)]
    }


def _tables(dtype, tile_h, error_mode=False):
    """The kernels' inputs as the port's render path builds them (CPU)."""
    scene = scene_buffers_from_numpy(_fields(), device="cpu", dtype=dtype)
    tiling = TilingConfig(tile_h, 128, 24, 48)
    obs = torch.from_numpy(np.random.RandomState(1).rand(*SIZE, 3)).to(dtype)
    with torch.no_grad():
        ij_off, signed_area, draw, background = prepare(scene)
        rt = raster_tables(scene, ij_off, draw, tiling)
        image, z_buffer, _ = rasterize_tiled_kernel(scene, ij_off, draw, background, tiling)
        edges = _build_edge_data(scene, ij_off, signed_area)
        cfg = EdgeAAConfig(SIZE[0], SIZE[1], 1.0, False, error_mode)
        et = edge_tables(cfg, edges, z_buffer, tiling)
        buffer = ((image - obs) ** 2).sum(-1) if error_mode else image
        buf, z_pad, obs_pad = pad_edge_buffers(cfg, buffer, z_buffer, obs, et.grid)
    return rt, et, buf, z_pad, obs_pad


def _np(t):
    return t.detach().numpy()


@pytest.mark.parametrize("tile_h", [48, 64])
def test_raster_plain_matches_pallas_interpret(tile_h):
    rt, _, _, _, _ = _tables(torch.float32, tile_h)
    grid, cap = rt.grid, rt.setup_tile.shape[1]
    d = rt.affine_tile.shape[2] // 3
    assert int(rt.counts.max()) > 1
    slot_map, z, vals = rk.raster_fwd(rt.setup_tile, rt.affine_tile, rt.counts, grid)

    cfg = PallasRasterConfig(grid.tile_h, grid.tile_w, grid.n_ty, grid.n_tx, cap, d, True, False, interpret=True)
    affine_j = jnp.swapaxes(jnp.concatenate([_np(rt.affine_tile), np.zeros((grid.n_tiles, 1, 3 * d), np.float32)], 1), 1, 2)
    setup_j = jnp.swapaxes(jnp.asarray(_np(rt.setup_tile)), 1, 2)
    counts_j = jnp.asarray(_np(rt.counts))[None, :]
    (slot_j, z_j, vals_j), vjp = jax.vjp(lambda a: raster_eval_pallas(cfg, a, setup_j, counts_j), affine_j)

    np.testing.assert_array_equal(_np(slot_map), np.asarray(slot_j))
    fin = np.isfinite(np.asarray(z_j))
    np.testing.assert_array_equal(fin, np.isfinite(_np(z)))
    assert np.abs(np.asarray(z_j)[fin] - _np(z)[fin]).max() < 1e-5
    assert np.abs(np.asarray(vals_j) - _np(vals)).max() < 1e-4

    g_vals = np.random.RandomState(2).rand(*vals.shape).astype(np.float32)
    (g_j,) = vjp((np.zeros(slot_j.shape, jax.dtypes.float0), jnp.zeros_like(z_j), jnp.asarray(g_vals)))
    g_j = np.swapaxes(np.asarray(g_j), 1, 2)  # (n_tiles, cap + 1, 3D)
    g_t = _np(rk.raster_bwd(slot_map, torch.from_numpy(g_vals), rt.counts, grid, cap))
    scale = max(np.abs(g_j).max(), 1.0)
    assert np.abs(g_j[:, :cap] - g_t).max() < 1e-3 * scale
    assert not g_j[:, cap].any()  # the TPU's miss row carries no gradient


@pytest.mark.parametrize("tile_h,error_mode", [(48, False), (64, False), (48, True)])
def test_edge_plain_matches_pallas_interpret(tile_h, error_mode):
    _, et, buf, z_pad, obs_pad, = _tables(torch.float32, tile_h, error_mode)
    grid, cap = et.grid, et.table_tile.shape[1]
    c = (et.table_tile.shape[2] - 25) // 3
    assert int(et.counts.max()) > 1
    out = ek.edge_fwd(et.table_tile, buf, z_pad, obs_pad, et.counts, grid, error_mode)

    cfg = PallasEdgeConfig(grid.tile_h, grid.tile_w, grid.n_ty, grid.n_tx, cap, c, error_mode, interpret=True)
    table_j = jnp.swapaxes(jnp.asarray(_np(et.table_tile)), 1, 2)
    obs_j = jnp.asarray(_np(obs_pad)) if error_mode else jnp.zeros((c,) + tuple(z_pad.shape), jnp.float32)
    counts_j = jnp.asarray(_np(et.counts))[None, :]
    out_j, vjp = jax.vjp(
        lambda t, b: edge_pass_pallas(cfg, t, b, jnp.asarray(_np(z_pad)), obs_j, counts_j), table_j, jnp.asarray(_np(buf))
    )
    assert np.abs(np.asarray(out_j) - _np(out)).max() < 1e-4

    g_out = np.random.RandomState(3).rand(*out.shape).astype(np.float32)
    g_table_j, g_buf0_j = vjp(jnp.asarray(g_out))
    g_rows, g_buf0 = ek.edge_bwd(et.table_tile, out, z_pad, obs_pad, torch.from_numpy(g_out), et.counts, grid, error_mode)
    g_table_j = np.swapaxes(np.asarray(g_table_j), 1, 2)  # (n_tiles, cap, W)
    g_rows_j = np.concatenate([g_table_j[:, :, 16:19], g_table_j[:, :, 21 : 21 + 3 * c]], axis=2)
    scale = max(np.abs(g_rows_j).max(), 1.0)
    assert np.abs(g_rows_j - _np(g_rows)).max() < 1e-3 * scale
    assert np.abs(np.asarray(g_buf0_j) - _np(g_buf0)).max() < 1e-4


def test_raster_plain_backward_matches_autograd_f64():
    rt, _, _, _, _ = _tables(torch.float64, 48)
    grid, cap = rt.grid, rt.setup_tile.shape[1]
    affine = rt.affine_tile.detach().clone().requires_grad_(True)
    slot_map, _, vals = rk.raster_fwd_reference(rt.setup_tile, affine, rt.counts, grid)
    g_vals = torch.from_numpy(np.random.RandomState(5).randn(*vals.shape))
    (g_auto,) = torch.autograd.grad((vals * g_vals).sum(), affine)
    g_plain = rk.raster_bwd_reference(slot_map, g_vals, rt.counts, grid, cap)
    scale = float(g_auto.abs().max())
    assert scale > 0
    assert float((g_auto - g_plain).abs().max()) <= 1e-9 * scale


@pytest.mark.parametrize("error_mode", [False, True])
def test_edge_plain_backward_matches_autograd_f64(error_mode):
    _, et, buf, z_pad, obs_pad = _tables(torch.float64, 48, error_mode)
    c = (et.table_tile.shape[2] - 25) // 3
    table = et.table_tile.detach().clone().requires_grad_(True)
    buf0 = buf.detach().clone().requires_grad_(True)
    out = ek.edge_fwd_reference(table, buf0, z_pad, obs_pad, et.counts, et.grid, error_mode)
    g_out = torch.from_numpy(np.random.RandomState(6).randn(*out.shape))
    g_table, g_buf = torch.autograd.grad((out * g_out).sum(), (table, buf0))
    g_rows, g_buf0 = ek.edge_bwd_reference(et.table_tile, out.detach(), z_pad, obs_pad, g_out, et.counts, et.grid,
                                           error_mode)
    differentiable = list(range(16, 19)) + list(range(21, 21 + 3 * c))
    g_auto = g_table[:, :, differentiable]
    scale = float(g_auto.abs().max())
    assert scale > 0
    assert float((g_auto - g_rows).abs().max()) <= 1e-9 * scale
    others = [j for j in range(g_table.shape[2]) if j not in differentiable]
    assert not g_table[:, :, others].any()
    assert float((g_buf - g_buf0).abs().max()) <= 1e-9 * float(g_buf.abs().max())


def test_wrappers_refuse_unknown_impl():
    rt, _, _, _, _ = _tables(torch.float32, 48)
    with pytest.raises(ValueError):
        rk.raster_fwd(rt.setup_tile, rt.affine_tile, rt.counts, rt.grid, impl="pallas")


@pytest.mark.parametrize("d", [3, 7])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("tile_h,blocks", [(8, 4), (16, 8), (32, 8), (48, 8)])
def test_raster_bwd_launch_shape(tile_h, blocks, dtype, d):
    """The backward kernel's launch shape at the planner's tile heights
    (width 128): a tile's blocks form one portable cluster (≤ 8 blocks of
    256 threads, looping over the rows beyond 16), each with a cap × 3D
    accumulator."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    shape = rk.raster_bwd_launch_shape(tile_h, 128, 56, d, itemsize)
    assert shape == (256, blocks, 56 * 3 * d * itemsize)
    assert shape.threads * shape.blocks_per_tile == min(tile_h * 128, rk.MAX_CLUSTER * rk.RASTER_BWD_THREADS)


def test_raster_bwd_launch_shape_refuses_what_no_block_holds():
    """cap × 3D × itemsize above the 232448 bytes of shared memory a block
    can use raises, naming cap, D and the limit; a tile smaller than the
    block gets fewer threads."""
    assert rk.raster_bwd_launch_shape(16, 128, 1383, 7, 8).smem_bytes == 232_344
    with pytest.raises(ValueError, match=r"cap=1384 .*3·D=21 .*232448"):
        rk.raster_bwd_launch_shape(16, 128, 1384, 7, 8)
    assert rk.raster_bwd_launch_shape(2, 40, 8, 3, 4) == (96, 1, 8 * 9 * 4)


@pytest.mark.parametrize("textured", [False, True], ids=["plain", "textured"])
@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("tile_h,plain,textured_shape", [(8, (2, 2, 1), (4, 1, 1)), (16, (3, 3, 1), (8, 1, 1)),
                                                         (32, (6, 3, 1), (8, 2, 1)), (48, (8, 3, 1), (8, 3, 1))])
def test_edge_bwd_launch_shape(tile_h, plain, textured_shape, dtype, c, textured):
    """The edge backward kernels' launch shape at the planner's tile heights
    (width 128): blocks of 256 threads, the fewest blocks a tile (a portable
    cluster of at most 8) and then the fewest pixels a lane (at most 3) that
    cover the tile in one pass (the textured kernel: the fewest pixels, then
    the fewest blocks), and shared memory for one 64-row chunk of the table,
    16 partial sums per warp and row, and two chunks' block sums: nothing
    that grows with the table's capacity."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    shape = ek.edge_bwd_launch_shape(tile_h, 128, c, textured, itemsize)
    blocks, pixels, passes = textured_shape if textured else plain
    row_w, grad_w = (35 + 3 * c, 12 + 3 * c) if textured else (25 + 3 * c, 3 + 3 * c)
    smem = (64 * row_w + 8 * 64 * 16 + 2 * 64 * grad_w) * itemsize
    assert shape == (256, blocks, pixels, smem)
    per_pass = shape.threads * shape.blocks_per_tile * shape.pixels_per_thread
    assert per_pass * (passes - 1) < tile_h * 128 <= per_pass * passes


def test_edge_bwd_launch_shape_small_tiles_and_largest_block():
    """A tile of fewer 16 × 2 patches than a block has warps gets a warp per
    patch and one block; a tile without pixels one warp that writes the zero
    rows; a tile larger than 8 blocks hold takes several passes; the largest
    shared memory any shape asks for (textured, float64, C = 4) fits a
    block, so no table is refused."""
    assert ek.edge_bwd_launch_shape(2, 40, 3, False, 4) == (96, 1, 1, (64 * 34 + 3 * 64 * 16 + 2 * 64 * 12) * 4)
    assert ek.edge_bwd_launch_shape(0, 128, 3, True, 4)[:3] == (32, 1, 1)
    shape = ek.edge_bwd_launch_shape(64, 128, 3, False, 4)
    assert shape[:3] == (256, 8, 3) and 8 * 256 * 3 < 64 * 128 <= 2 * 8 * 256 * 3
    largest = max(ek.edge_bwd_launch_shape(th, 128, c, tex, 8).smem_bytes
                  for th in (8, 16, 32, 48, 64) for c in (1, 2, 3, 4) for tex in (False, True))
    assert largest == (64 * 47 + 8 * 64 * 16 + 2 * 64 * 24) * 8 <= rk.MAX_SMEM_BYTES


@pytest.mark.parametrize("textured", [False, True], ids=["plain", "textured"])
def test_covered_visits_counts_the_per_pixel_band_tests(textured):
    """covered_visits, the count behind the edge kernels' operations bound,
    on the synthetic tables: every (pixel, slot) pair the band mask paints
    is counted, slots at or above a tile's count are not, and most pairs of
    these thin bands fail the clip planes or the y range."""
    from deodr_tpu_torch.ops.kernels import tile_coords, to_tiles
    from torch_port_scenes import synthetic_edge_tables

    table, _, _, _, z_pad, _, counts, grid = synthetic_edge_tables(16, 3, False, textured)
    yy, xx = tile_coords(grid, table.dtype, table.device)
    zb = to_tiles(z_pad, grid)
    count = counts.to(torch.int64).clamp(max=table.shape[1])
    painted = all_pairs = 0
    for k in range(int(count.max())):
        mask, _ = ek._band_mask_and_t(table[:, k, :, None, None], yy, xx, zb, 3)
        painted += int((mask & (k < count)[:, None, None]).sum())
        all_pairs += int((k < count).sum()) * grid.tile_h * grid.tile_w
    covered = ek.covered_visits(table, counts, grid)
    assert 0 < painted <= covered < all_pairs // 4
    more = counts.clone()
    more[int(torch.argmin(counts))] = table.shape[1]  # the padding rows of one more tile hold bands too
    assert ek.covered_visits(table, more, grid) > covered


@pytest.mark.parametrize("error_mode", [False, True], ids=["image", "error"])
@pytest.mark.parametrize("textured", [False, True], ids=["plain", "textured"])
def test_edge_plain_backward_matches_autograd_f64_many_slots(textured, error_mode):
    """The plain backward versions against autograd of their plain forward
    versions, in float64, on the synthetic tables of the card tests: tiles
    of 0, 1, 31, 33 and 70 slots, one at the capacity (72) and one above it,
    half the slots textured where ``textured``."""
    from deodr_tpu_torch.ops.kernels import edge_tex_kernel as etk
    from torch_port_scenes import synthetic_edge_tables

    table, texture, buf, _, z_pad, obs_pad, counts, grid = synthetic_edge_tables(16, 3, error_mode, textured)
    leaves = [table.clone().requires_grad_(True), buf.clone().requires_grad_(True)]
    if textured:
        leaves.append(texture.clone().requires_grad_(True))
        out = etk.edge_tex_fwd_reference(leaves[0], leaves[2], leaves[1], z_pad, obs_pad, counts, grid, error_mode)
    else:
        out = ek.edge_fwd_reference(leaves[0], leaves[1], z_pad, obs_pad, counts, grid, error_mode)
    g_out = torch.from_numpy(np.random.RandomState(7).randn(*out.shape))
    auto = torch.autograd.grad((out * g_out).sum(), leaves)
    c = 3
    differentiable = list(range(16, 19)) + list(range(21, 21 + 3 * c))
    if textured:
        g_rows, g_buf0, g_tex = etk.edge_tex_bwd_reference(table, texture, out.detach(), z_pad, obs_pad, g_out, counts,
                                                           grid, error_mode)
        differentiable += list(range(25 + 3 * c, 34 + 3 * c))
        assert float((auto[2] - g_tex).abs().max()) <= 1e-9 * float(auto[2].abs().max())
    else:
        g_rows, g_buf0 = ek.edge_bwd_reference(table, out.detach(), z_pad, obs_pad, g_out, counts, grid, error_mode)
    g_auto = auto[0][:, :, differentiable]
    scale = float(g_auto.abs().max())
    assert scale > 0 and int((g_rows[:, :, 0] != 0).sum()) > 64
    assert float((g_auto - g_rows).abs().max()) <= 1e-9 * scale
    assert float((auto[1] - g_buf0).abs().max()) <= 1e-9 * float(auto[1].abs().max())


MODES = {"nonstrict": (False, False), "persp": (True, True), "nonstrict-persp": (False, True)}


def _mode_tables(dtype, tile_h, strict, persp):
    """The raster kernel's tables of the soup in a coverage and depth mode
    (depths tilted per vertex, so that 1/z varies across a triangle)."""
    f = dict(_fields(), strict_edge=strict, perspective_correct=persp)
    f["depths"] = f["depths"] + 0.5 * np.random.RandomState(7).rand(len(f["depths"]))
    scene = scene_buffers_from_numpy(f, device="cpu", dtype=dtype)
    with torch.no_grad():
        ij_off, _, draw, _ = prepare(scene)
        return raster_tables(scene, ij_off, draw, TilingConfig(tile_h, 128, 24, 48))


@pytest.mark.parametrize("mode", list(MODES))
def test_raster_plain_modes_match_pallas_interpret(mode):
    """B1's plain version in its non-strict and perspective modes against
    the Pallas kernel in the same modes (interpret mode) on identical
    float32 tables: slot_map exact, z within 1e-5, vals within 1e-4, the
    affine-table cotangent within 1e-3 of scale; and its covered-pair count
    (the operations bound's) against the JAX coverage predicate."""
    from deodr_tpu.ops.pallas.raster_kernel import _coverage_and_z
    from deodr_tpu_torch.ops.kernels import tile_coords

    strict, persp = MODES[mode]
    rt = _mode_tables(torch.float32, 48, strict, persp)
    grid, cap = rt.grid, rt.setup_tile.shape[1]
    d = rt.affine_tile.shape[2] // 3
    assert d == (4 if persp else 3)
    slot_map, z, vals = rk.raster_fwd(rt.setup_tile, rt.affine_tile, rt.counts, grid, strict=strict, persp=persp)
    cfg = PallasRasterConfig(grid.tile_h, grid.tile_w, grid.n_ty, grid.n_tx, cap, d, strict, persp, interpret=True)
    affine_j = jnp.swapaxes(jnp.concatenate([_np(rt.affine_tile), np.zeros((grid.n_tiles, 1, 3 * d), np.float32)], 1), 1, 2)
    setup_j = jnp.swapaxes(jnp.asarray(_np(rt.setup_tile)), 1, 2)
    counts_j = jnp.asarray(_np(rt.counts))[None, :]
    (slot_j, z_j, vals_j), vjp = jax.vjp(lambda a: raster_eval_pallas(cfg, a, setup_j, counts_j), affine_j)
    np.testing.assert_array_equal(_np(slot_map), np.asarray(slot_j))
    fin = np.isfinite(np.asarray(z_j))
    assert fin.sum() > 1000
    np.testing.assert_array_equal(fin, np.isfinite(_np(z)))
    assert np.abs(np.asarray(z_j)[fin] - _np(z)[fin]).max() < 1e-5
    assert np.abs(np.asarray(vals_j) - _np(vals)).max() < 1e-4
    g_vals = np.random.RandomState(2).rand(*vals.shape).astype(np.float32)
    (g_j,) = vjp((np.zeros(slot_j.shape, jax.dtypes.float0), jnp.zeros_like(z_j), jnp.asarray(g_vals)))
    g_j = np.swapaxes(np.asarray(g_j), 1, 2)
    g_t = _np(rk.raster_bwd(slot_map, torch.from_numpy(g_vals), rt.counts, grid, cap))
    assert np.abs(g_j[:, :cap] - g_t).max() < 1e-3 * max(np.abs(g_j).max(), 1.0)

    yy, xx = tile_coords(grid, torch.float32, "cpu")
    yrow, xs = jnp.asarray(_np(yy)), jnp.asarray(_np(xx.expand(grid.n_tiles, grid.tile_h, grid.tile_w)))
    setup, counts = _np(rt.setup_tile), _np(rt.counts)
    want = 0
    for k in range(int(counts.max())):
        cov, _ = _coverage_and_z(cfg, lambda j, k=k: jnp.asarray(setup[:, k, j])[:, None, None], yrow, xs)
        want += int((np.asarray(cov) & (k < counts)[:, None, None]).sum())
    assert rk.covered_visits(rt.setup_tile, rt.counts, grid, strict, persp) == want


@pytest.mark.parametrize("table", ["soup", "synthetic"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("mode", list(MODES))
def test_raster_region_cull_keeps_covered_pairs_in_every_mode(mode, dtype, table):
    """The plain mirror of B1f's region cull in the non-strict and
    perspective modes keeps every (warp region, slot) pair where the slot
    covers a pixel of the region: on the soup and on the synthetic raster
    tables of the mode (vertices on warp-region corners, a = 0 edges, a
    depth plane through 0, NaN and invalid rows)."""
    from deodr_tpu_torch.ops.kernels import tile_coords
    from torch_port_scenes import synthetic_raster_tables

    strict, persp = MODES[mode]
    if table == "soup":
        rt = _mode_tables(dtype, 48, strict, persp)
        rows, counts, grid = rt.setup_tile, rt.counts, rt.grid
    else:
        rows, _, counts, grid = synthetic_raster_tables(16, 3, dtype, strict=strict, persp=persp)
    yy, xx = tile_coords(grid, dtype, "cpu")
    cov = rk._coverage(rows[:, :, :, None, None], yy[:, None], xx[:, None], -torch.finfo(dtype).tiny, strict,
                       persp)[0]
    cap = rows.shape[1]
    used = torch.arange(cap)[None, :] < counts.to(torch.int64).clamp(max=cap)[:, None]
    cov = cov & used[:, :, None, None]
    assert int(cov.sum()) > 0
    kept = rk.region_cull(rows, counts, grid, strict)
    needed = _regions_covered(cov, grid, rk.RASTER_FWD_PIXELS)
    assert int((needed & ~kept).sum()) == 0
    if table == "soup":
        assert int(kept.sum()) < int(used.sum()) * kept.shape[1] // 2


# ------------------------------------------------------------- the forward kernels' region cull


@pytest.mark.parametrize("tile_h", [48, 64])
def test_raster_covered_visits_matches_jax_coverage(tile_h):
    """raster_kernel.covered_visits, the count behind B1f's operations
    bound, equals the (pixel, slot) pairs that the JAX package's coverage
    predicate (``_coverage_and_z``, strict edge, affine depth) covers,
    evaluated eagerly slot by slot on the same float32 tables."""
    from deodr_tpu.ops.pallas.raster_kernel import _coverage_and_z
    from deodr_tpu_torch.ops.kernels import tile_coords

    rt, _, _, _, _ = _tables(torch.float32, tile_h)
    grid, cap = rt.grid, rt.setup_tile.shape[1]
    cfg = PallasRasterConfig(grid.tile_h, grid.tile_w, grid.n_ty, grid.n_tx, cap, 3, True, False)
    yy, xx = tile_coords(grid, torch.float32, "cpu")
    yrow, xs = jnp.asarray(_np(yy)), jnp.asarray(_np(xx.expand(grid.n_tiles, grid.tile_h, grid.tile_w)))
    setup, counts = _np(rt.setup_tile), _np(rt.counts)
    want = 0
    for k in range(int(counts.max())):
        cov, _ = _coverage_and_z(cfg, lambda j, k=k: jnp.asarray(setup[:, k, j])[:, None, None], yrow, xs)
        want += int((np.asarray(cov) & (k < counts)[:, None, None]).sum())
    assert want > 0
    assert rk.covered_visits(rt.setup_tile, rt.counts, grid) == want


def _adversarial_edge_table(dtype, tile_h=16, textured=False):
    """The synthetic edge tables (tile_h × 128 tiles, textured rows where
    ``textured``) with hand-made bands in the slots of the fullest tile:
    clip planes through warp-region corners whose thresholds are met exactly
    at a pixel, zero, denormal and NaN coefficients, a NaN threshold and y
    range, and an inactive band."""
    from torch_port_scenes import synthetic_edge_tables

    table, _, _, _, _, _, counts, grid = synthetic_edge_tables(tile_h, 3, False, textured, dtype)
    t = int(torch.argmax(counts))
    x0, y0 = (t % grid.n_tx) * grid.tile_w, (t // grid.n_tx) * grid.tile_h
    tiny = torch.finfo(dtype).tiny
    den = tiny / 8
    nan = float("nan")
    box = [(1, 0, -(x0 + 16), 0), (-1, 0, x0 + 48, -tiny), (0, 1, -(y0 + 2), -1), (0, -1, y0 + 6, 0)]
    bands = [
        box,  # x0 + 16 < x ≤ x0 + 48, y0 + 2 ≤ y < y0 + 6: each threshold met exactly at a pixel
        [(0, 0, 0, -tiny), (0, 0, 0, -tiny), (0, 0, 0, -tiny), (0, 0, 0, -tiny)],  # zero planes: everywhere
        [(0, 0, 0, 0)] + box[1:],  # a zero plane against a 0 threshold: nowhere
        [(den, 0, -den * (x0 + 3), 0), (-den, 0, den * (x0 + 8), -tiny)] + box[2:],  # denormal planes
        [(nan, 0, 0, -1)] + box[1:],
        box[:3] + [(0, -1, y0 + 6, nan)],
    ]
    for k, planes in enumerate(bands):
        row = table[t, k]
        for i, (a, b, c, th) in enumerate(planes):
            row[3 * i : 3 * i + 3] = torch.tensor([a, b, c], dtype=dtype)
            row[12 + i] = th
        row[19], row[20] = y0 - 1.0, y0 + grid.tile_h
    table[t, len(bands), 19] = nan  # a NaN y range
    table[t, len(bands) + 1, 24 + 3 * 3] = 0.0  # inactive
    return table, counts, grid


def _regions_covered(cov, grid, pixels):
    """(n_tiles, regions, cap): whether a slot covers some pixel of a warp
    region, from per-pixel coverage cov (n_tiles, cap, tile_h, tile_w); a
    region is 2·rp rows × 16·cp columns of the tile, as ``region_pixel`` in
    csrc/common.cuh lays them out."""
    from deodr_tpu_torch.ops import kernels

    nt, cap = cov.shape[:2]
    g = kernels.warp_regions(grid.tile_h, grid.tile_w, pixels)
    ly = torch.arange(grid.tile_h)[:, None] // (2 * g.rp)
    lx = torch.arange(grid.tile_w)[None, :] // (16 * g.cp)
    region = (ly * g.cols + lx).reshape(-1)
    hits = torch.zeros((nt, cap, g.count), dtype=torch.int64).index_add_(2, region, cov.reshape(nt, cap, -1).long())
    return (hits > 0).transpose(1, 2)


@pytest.mark.parametrize("table", ["soup", "adversarial"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("kernel", ["raster", "edge", "edge_tex"])
def test_region_culls_never_drop_a_covered_pair(kernel, dtype, table):
    """The plain mirrors of the forward kernels' region culls
    (``raster_may_cover``, ``band_may_cover``) keep every (warp region, slot)
    pair where the slot covers a pixel of the region (the raster coverage
    predicate; a band's y range and clip planes), on every region of every
    tile, at each kernel's pixels a lane; on the soup (for the textured
    edge kernel: the textured synthetic tables) they drop most of the other
    pairs."""
    from deodr_tpu_torch.ops.kernels import edge_tex_kernel as etk
    from deodr_tpu_torch.ops.kernels import tile_coords
    from torch_port_scenes import synthetic_edge_tables, synthetic_raster_tables

    if kernel == "raster":
        if table == "soup":
            rt = _tables(dtype, 48)[0]
            rows, counts, grid = rt.setup_tile, rt.counts, rt.grid
        else:
            rows, _, counts, grid = synthetic_raster_tables(16, 3, dtype)
        module, pixels = rk, rk.RASTER_FWD_PIXELS
        neg_tiny = -torch.finfo(dtype).tiny
        yy, xx = tile_coords(grid, dtype, "cpu")
        cov = rk._coverage(rows[:, :, :, None, None], yy[:, None], xx[:, None], neg_tiny)[0]
    else:
        if kernel == "edge_tex" and table == "soup":
            rows, _, _, _, _, _, counts, grid = synthetic_edge_tables(16, 3, False, True, dtype)
        elif table == "soup":
            et = _tables(dtype, 48)[1]
            rows, counts, grid = et.table_tile, et.counts, et.grid
        else:
            rows, counts, grid = _adversarial_edge_table(dtype, textured=kernel == "edge_tex")
        module, pixels = (etk, etk.TEX_FWD_PIXELS) if kernel == "edge_tex" else (ek, ek.EDGE_FWD_PIXELS)
        yy, xx = tile_coords(grid, dtype, "cpu")
        r, yy, xx = rows[:, :, :, None, None], yy[:, None], xx[:, None]
        cov = (yy >= r[:, :, ek._E_YBEG]) & (yy <= r[:, :, ek._E_YEND])
        for i in range(4):
            cov = cov & (r[:, :, 3 * i] * xx + (r[:, :, 3 * i + 1] * yy + r[:, :, 3 * i + 2]) > r[:, :, ek._E_TH + i])
    cap = rows.shape[1]
    used = torch.arange(cap)[None, :] < counts.to(torch.int64).clamp(max=cap)[:, None]
    cov = cov & used[:, :, None, None]
    assert int(cov.sum()) > 0
    kept = module.region_cull(rows, counts, grid)
    needed = _regions_covered(cov, grid, pixels)
    assert kept.shape == needed.shape
    assert int((needed & ~kept).sum()) == 0
    if table == "soup":
        assert int(kept.sum()) < int(used.sum()) * kept.shape[1] // 4


@pytest.mark.parametrize("kernel", ["raster", "edge", "edge_tex"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("tile_h", [8, 16, 32, 48])
def test_fwd_launch_shape(tile_h, dtype, kernel):
    """The forward kernels' launch shapes at the planner's tile heights
    (width 128), at the pixels a lane each kernel holds (1 for the raster
    and textured edge kernels, 2 for the edge kernel): blocks of 256
    threads, as many a tile as hold its pixels once, and shared memory for
    two 64-row chunks of the table (rows of 35 + 3C for the textured
    kernel)."""
    from deodr_tpu_torch.ops.kernels import edge_tex_kernel as etk

    itemsize = torch.empty((), dtype=dtype).element_size()
    if kernel == "raster":
        shape, width, pixels = rk.raster_fwd_launch_shape(tile_h, 128, itemsize), 22, rk.RASTER_FWD_PIXELS
    elif kernel == "edge":
        shape, width, pixels = ek.edge_fwd_launch_shape(tile_h, 128, 3, itemsize), 34, ek.EDGE_FWD_PIXELS
    else:
        shape, width, pixels = etk.edge_tex_fwd_launch_shape(tile_h, 128, 3, itemsize), 44, etk.TEX_FWD_PIXELS
    assert shape == (256, tile_h * 128 // (256 * pixels), 2 * 64 * width * itemsize)
    assert shape.threads * shape.blocks_per_tile * pixels == tile_h * 128


def test_fwd_launch_shape_small_tiles_and_other_pixel_counts():
    """The forward frame's shared helper (``kernels.fwd_launch_shape``,
    ``fwd_shape`` in csrc/common.cuh, which lays out a kernel's regions at
    its own pixels a lane): a tile of fewer warp regions than a block has
    warps gets one block of a warp per region (regions of 1, 2 or 4 patches
    side by side on a one-patch-high tile); a tile without pixels one warp,
    in each kernel's helper."""
    from deodr_tpu_torch.ops import kernels
    from deodr_tpu_torch.ops.kernels import edge_tex_kernel as etk

    assert [kernels.fwd_launch_shape(2, 40, p, 22, 4) for p in (1, 2, 4)] == [
        (96, 1, 2 * 64 * 22 * 4), (64, 1, 2 * 64 * 22 * 4), (32, 1, 2 * 64 * 22 * 4)]
    assert rk.raster_fwd_launch_shape(2, 40, 4) == (96, 1, 2 * 64 * 22 * 4)
    assert rk.raster_fwd_launch_shape(0, 128, 4) == (32, 1, 2 * 64 * 22 * 4)
    assert ek.edge_fwd_launch_shape(0, 128, 1, 8) == (32, 1, 2 * 64 * 28 * 8)
    assert etk.edge_tex_fwd_launch_shape(2, 40, 3, 4) == (96, 1, 2 * 64 * 44 * 4)
    assert etk.edge_tex_fwd_launch_shape(0, 128, 1, 8) == (32, 1, 2 * 64 * 38 * 8)
