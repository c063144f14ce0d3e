"""The port's tiled route (deodr_tpu_torch) in the modes that the raster
kernel B1 gained beside its strict, affine one: ``strict_edge=False``
(rational non-strict coverage) and ``perspective_correct=True`` (the depth
of the plane of 1/z, attributes divided by it), against the JAX package's
``render_scene(tiling=..., impl="pallas", impl_interpret=True)`` on the CPU,
on the tilted mixed soup of tests/test_torch_port_untiled.py.

- Non-strict: image (or error buffer), z-buffer and the gradients to ij,
  colors, depths, the background and (textured) uv, shade and texture,
  against the JAX Pallas route (the textured edge kernel with a texture
  plan; the untextured edge kernel).
- Perspective-correct: the edges take the sequential pass in both packages
  (JAX sends the untextured scene to its XLA tiled pass, ``impl="xla"``
  checked too, which matches its sequential pass). Image and z-buffer
  against the JAX tiled routes; the gradients against the JAX untiled route,
  since both JAX tiled routes give NaN gradients here (the cotangent of an
  uncovered pixel is 0 · ∞ after the perspective recovery, and their
  backward multiplies it by a zero mask instead of selecting).

Bounds as in tests/test_torch_port_untiled.py: 1e-9 in float64; image 1e-4,
z 1e-5, gradients 1e-3 of scale in float32.
"""

import jax.numpy as jnp
import pytest
import torch

from deodr_tpu.ops.tiled import EdgeTexPlan as JaxEdgeTexPlan
from deodr_tpu.ops.tiled import TilingConfig as JaxTilingConfig
import deodr_tpu_torch as port
from test_torch_port_untiled import SIGMA, assert_close, jax_render, port_render, soup
from torch_port_scenes import AA_EDGE_CAPACITY, JAX_WINDOW, TILING

TEX_TILING = dict(TILING, tex_tile_capacity=64)


def _kwargs(textured, jax_side, plan=True):
    """render_scene arguments of the tiled route (a texture plan for a
    textured scene)."""
    tiling = TEX_TILING if textured else TILING
    if jax_side:
        kw = dict(tiling=JaxTilingConfig(**tiling), impl="pallas", impl_interpret=True)
        if textured and plan:
            kw["aa_tex_plan"] = JaxEdgeTexPlan(**JAX_WINDOW)
    else:
        kw = dict(tiling=port.TilingConfig(**tiling), check_capacity=True)
        if textured and plan:
            kw["aa_tex_plan"] = port.EdgeTexPlan()
    return dict(kw, aa_edge_capacity=AA_EDGE_CAPACITY)


# (textured, error mode)
NONSTRICT = {"textured-error": (True, True), "plain-image": (False, False)}
PERSP = {"textured-image": (True, False), "plain-error": (False, True)}


@pytest.mark.parametrize("case", list(NONSTRICT))
def test_tiled_nonstrict_matches_jax_pallas_f64(case):
    textured, error_mode = NONSTRICT[case]
    f = soup(textured, strict=False)
    assert_close(port_render(f, SIGMA, error_mode, **_kwargs(textured, False)),
                 jax_render(f, SIGMA, error_mode, **_kwargs(textured, True)))


@pytest.mark.parametrize("case", list(PERSP))
def test_tiled_perspective_matches_jax_f64(case):
    textured, error_mode = PERSP[case]
    f = soup(textured, persp=True)
    got = port_render(f, SIGMA, error_mode, **_kwargs(textured, False))
    untiled = jax_render(f, SIGMA, error_mode, aa_edge_capacity=AA_EDGE_CAPACITY)
    assert_close(got, jax_render(f, SIGMA, error_mode, **_kwargs(textured, True)), grads_from=untiled)
    if not textured:
        xla = dict(_kwargs(False, True), impl="xla", impl_interpret=False)
        assert_close(got, jax_render(f, SIGMA, error_mode, **xla), grads_from=untiled)


def test_tiled_textured_perspective_fetches_the_full_frame_f64():
    """A perspective-correct textured scene fetches its texels on the full
    frame after the perspective recovery, though its tiling asks for the
    block-compacted fetch (σ = 0, non-strict)."""
    f = soup(True, strict=False, persp=True)
    untiled = jax_render(f, 0.0, False)
    assert_close(port_render(f, 0.0, False, **_kwargs(True, False, plan=False)),
                 jax_render(f, 0.0, False, **_kwargs(True, True, plan=False)), grads_from=untiled)


@pytest.mark.parametrize("case", ["nonstrict-textured-error", "persp-plain-image"])
def test_tiled_new_modes_match_jax_f32(case):
    textured, error_mode, strict, persp = (True, True, False, False) if case.startswith("non") else (
        False, False, True, True)
    f = soup(textured, strict, persp)
    got = port_render(f, SIGMA, error_mode, torch.float32, **_kwargs(textured, False))
    want = jax_render(f, SIGMA, error_mode, jnp.float32, **_kwargs(textured, True))
    untiled = jax_render(f, SIGMA, error_mode, jnp.float32, aa_edge_capacity=AA_EDGE_CAPACITY) if persp else None
    assert_close(got, want, f64=False, grads_from=untiled)
