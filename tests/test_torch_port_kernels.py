"""The port's kernel modules (deodr_tpu_torch.ops.kernels) on the CPU, where
each wrapper runs its plain PyTorch version:

- against the JAX package's Pallas kernels in interpret mode on identical
  float32 tables (forward outputs and vjp cotangents), with the tolerances
  of tests/test_pallas_kernels.py; slot_map must match exactly;
- each plain backward against autograd through its plain forward, in
  float64, to 1e-9 relative.

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
