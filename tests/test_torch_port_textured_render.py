"""The port's textured ``render_scene`` in float64 against the JAX package's
``render_scene(..., impl="pallas", impl_interpret=True, aa_tex_plan=...)`` on
the CPU, on the mixed scene of tests/test_edge_tex_pallas.py (96×128, 12
triangles, 64² texture): at σ = 1.5 in image and error mode with the unsplit
and the split plan, and in image mode with the uv running off an 8×8 texture
(the border clamps), no pixel differs by more than 1e-9 and the gradients to
ij, colors, uv, shade and texture agree within 1e-8 of their scale; at σ = 0
the textured solid pass alone is held to the same limits, with culled
triangles, ``drawn_capacity`` and ``edge_tile_h`` set.

The scene, the loss and the helpers that call both renderers are those of
tests/test_torch_port_textured.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_port_textured import DIFF, _jax_render, _port_render
from torch_port_scenes import HEIGHT, SIGMA, TILING, WIDTH, mixed_scene_fields, plan_scene


@pytest.mark.parametrize(
    "plan,error_mode",
    [("unsplit", False), ("unsplit", True), ("split", False), ("split", True), ("clamped", False)],
    ids=["unsplit-image", "unsplit-error", "split-image", "split-error", "clamped-image"],
)
def test_textured_render_matches_jax_f64(plan, error_mode):
    f, kw = plan_scene(plan)
    out_j, zb_j, g_j = _jax_render(f, SIGMA, error_mode, jnp.float64, kw)
    out_p, zb_p, g_p = _port_render(f, SIGMA, error_mode, torch.float64, kw)
    fin = np.isfinite(zb_j)
    np.testing.assert_array_equal(fin, np.isfinite(zb_p))
    assert np.abs(zb_j[fin] - zb_p[fin]).max() <= 1e-9
    diff = np.abs(out_j - out_p).reshape(HEIGHT, WIDTH, -1).max(axis=-1)
    assert int((diff > 1e-9).sum()) == 0, f"{int((diff > 1e-9).sum())} differing pixels (max {diff.max()})"
    for k in DIFF:
        scale = max(1.0, float(np.abs(g_j[k]).max()))
        assert np.abs(g_p[k] - g_j[k]).max() <= 1e-8 * scale, k
        assert np.abs(g_p[k]).max() > 0, k


@pytest.mark.parametrize("error_mode", [False, True], ids=["image", "error"])
def test_textured_render_sigma0_matches_jax(error_mode):
    f = mixed_scene_fields()
    tiling = dict(TILING, drawn_capacity=12, edge_tile_h=8)
    f["faces"] = f["faces"].copy()
    f["faces"][:2] = f["faces"][:2, ::-1]  # culled triangles: the drawn compaction moves textured ones
    out_j, zb_j, g_j = _jax_render(f, 0.0, error_mode, jnp.float64, None, tiling=tiling)
    out_p, zb_p, g_p = _port_render(f, 0.0, error_mode, torch.float64, None, tiling=tiling)
    np.testing.assert_array_equal(np.isfinite(zb_j), np.isfinite(zb_p))
    assert np.abs(out_j - out_p).max() <= 1e-9
    for k in DIFF:
        scale = max(1.0, float(np.abs(g_j[k]).max()))
        assert np.abs(g_p[k] - g_j[k]).max() <= 1e-8 * scale, k
