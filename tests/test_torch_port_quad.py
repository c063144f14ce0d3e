"""The port's quad-granular texture fetch and kernel B4's plain versions
against the JAX package on the CPU, inputs made from a seed with numpy:

- ``quad_window_table`` (exact) and ``bilinear_sample_quads``, values and
  gradients to uv and texture, with and without quads that take the
  per-pixel fallback (built as tests/test_quad_fetch.py builds them),
  against the JAX XLA extraction (1e-12) and the JAX Pallas kernel in
  interpret mode (1e-13: the soft one-hot sums in another order);
- ``quad_blend_fwd_reference`` / ``quad_blend_bwd_reference`` against JAX
  ``quad_blend(QuadBlendConfig(..., interpret=True))`` and its VJP, the
  layouts transposed here (1e-13);
- a fallback list that overflows: ``render_scene(check_capacity=True)``
  raises naming "quad-fetch fallback compaction";
- ``Scene3D.render`` + ``render_backward`` at σ = 1 with the quad fetch on
  the textured torus against the JAX path (the check of
  tests/test_torch_port_scene3d.py, which holds the per-pixel fetch).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deodr_tpu_torch as port
from deodr_tpu.ops.common import bilinear_sample_quads as jax_bilinear_sample_quads
from deodr_tpu.ops.common import quad_window_table as jax_quad_window_table
from deodr_tpu.ops.pallas.quad_blend_kernel import QuadBlendConfig, quad_blend
from deodr_tpu_torch.ops.common import bilinear_sample, bilinear_sample_quads, quad_window_table
from deodr_tpu_torch.ops.kernels.quad_blend_kernel import quad_blend_bwd_reference, quad_blend_fwd_reference
from test_torch_port_scene3d import check_scene3d_render_and_backward


def _make_case(seed=0, q=64, th=32, tw=48, bad_frac=0.2):
    """Quads of 4 pixels within ~2 texels of each other (some beyond the
    texture's borders), a fraction with one far pixel (a uv seam), and a
    random pixel mask that keeps pixel 0 of each quad."""
    rng = np.random.default_rng(seed)
    texture = rng.standard_normal((th, tw, 3))
    base = rng.uniform(-2.0, max(th, tw) + 2.0, size=(q, 1, 2))
    uv = base + rng.uniform(0, 2.0, size=(q, 4, 2))
    n_bad = int(q * bad_frac)
    uv[:n_bad, 3, :] = rng.uniform(0, min(th, tw) - 2, size=(n_bad, 2)) + 20.0
    mask = rng.uniform(size=(q, 4)) > 0.2
    mask[:, 0] = True
    weight = rng.standard_normal((q, 4, 3)) * mask[..., None]
    return texture, uv, mask, weight


def test_quad_window_table_matches_jax():
    texture = np.random.default_rng(1).standard_normal((10, 14, 3))
    table = quad_window_table(torch.from_numpy(texture))
    assert tuple(table.shape) == (5 * 7, 192)
    np.testing.assert_array_equal(table.numpy(), np.asarray(jax.jit(jax_quad_window_table)(jnp.asarray(texture))))


@pytest.mark.parametrize("use_kernel,bad_frac", [(False, 0.2), (False, 0.0), (True, 0.2)],
                         ids=["xla-fallback", "xla-no-fallback", "kernel-interpret-fallback"])
def test_bilinear_sample_quads_matches_jax(use_kernel, bad_frac):
    texture, uv, mask, weight = _make_case(bad_frac=bad_frac)

    def loss(t, u):
        out = jax_bilinear_sample_quads(t, u, jnp.asarray(mask), 64, use_kernel=use_kernel, interpret=True)
        return jnp.sum(out * weight), out

    (_, out_j), (g_tex_j, g_uv_j) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        jnp.asarray(texture), jnp.asarray(uv))
    tex_t = torch.from_numpy(texture).requires_grad_(True)
    uv_t = torch.from_numpy(uv).requires_grad_(True)
    checks = []
    out_p = bilinear_sample_quads(tex_t, uv_t, torch.from_numpy(mask), 64, checks)
    g_tex_p, g_uv_p = torch.autograd.grad((out_p * torch.from_numpy(weight)).sum(), (tex_t, uv_t))
    tol = 1e-13 if use_kernel else 1e-12
    assert np.abs(out_p.detach().numpy() - np.asarray(out_j))[mask].max() <= tol
    assert np.abs(g_tex_p.numpy() - np.asarray(g_tex_j)).max() <= tol
    assert np.abs((g_uv_p.numpy() - np.asarray(g_uv_j)) * mask[..., None]).max() <= tol
    # the per-pixel fetch of the masked pixels, and the fallback count
    ref = bilinear_sample(torch.from_numpy(texture), torch.from_numpy(uv)).numpy()
    assert np.abs(out_p.detach().numpy() - ref)[mask].max() == 0.0
    assert checks[0][0] == "quad-fetch fallback compaction"
    assert (int(checks[0][1]) > 0) == (bad_frac > 0)


def _blend_inputs(q=100, c=3, seed=2):
    """Window rows, offsets (0..6, so that taps reach the window's last row
    and column), weights and a cotangent."""
    rng = np.random.default_rng(seed)
    win = rng.standard_normal((q, 64 * c))
    dv = rng.integers(0, 7, size=(q, 4)).astype(np.int32)
    du = rng.integers(0, 7, size=(q, 4)).astype(np.int32)
    dv[0], du[0] = 6, 6
    ev, eu = rng.uniform(size=(q, 4)), rng.uniform(size=(q, 4))
    ev[1], eu[1] = 0.0, 1.0  # the weights of clamped coordinates
    ct = rng.standard_normal((q, 4, c))
    return win, dv, du, ev, eu, ct


def test_quad_blend_plain_versions_match_jax_kernel():
    win, dv, du, ev, eu, ct = _blend_inputs()
    q, c = win.shape[0], 3
    bq = 128
    qp = -(-q // bq) * bq
    pad = qp - q

    def t4(a):
        return jnp.pad(jnp.asarray(a, jnp.float64).T, ((0, 0), (0, pad)))

    win_t = jnp.pad(jnp.asarray(win).T, ((0, 0), (0, pad)))
    coeffs = jnp.concatenate([t4(dv), t4(du), t4(ev), t4(eu)], axis=0)
    cfg = QuadBlendConfig(nb_colors=c, block_q=bq, n_blocks=qp // bq, interpret=True)
    # out and cotangent rows are c-major: row c·4 + p
    ct_t = jnp.pad(jnp.asarray(ct).transpose(2, 1, 0).reshape(4 * c, q), ((0, 0), (0, pad)))
    out_t, vjp = jax.vjp(lambda w, k: quad_blend(cfg, w, k), win_t, coeffs)
    d_win_t, d_coef = vjp(ct_t)
    out_j = np.asarray(out_t).reshape(c, 4, qp)[:, :, :q].transpose(2, 1, 0)
    d_win_j = np.asarray(d_win_t)[:, :q].T
    d_ev_j, d_eu_j = np.asarray(d_coef)[8:12, :q].T, np.asarray(d_coef)[12:16, :q].T

    args = [torch.from_numpy(a) for a in (win, dv, du, ev, eu)]
    out_p = quad_blend_fwd_reference(*args)
    d_win_p, d_ev_p, d_eu_p = quad_blend_bwd_reference(*args, torch.from_numpy(ct))
    assert out_p.shape == (q, 4, c) and d_win_p.shape == win.shape
    assert np.abs(out_p.numpy() - out_j).max() <= 1e-13
    assert np.abs(d_win_p.numpy() - d_win_j).max() <= 1e-13
    assert np.abs(d_ev_p.numpy() - d_ev_j).max() <= 1e-13
    assert np.abs(d_eu_p.numpy() - d_eu_j).max() <= 1e-13
    assert (d_win_p.numpy() == 0).mean() > 0.5  # dense row: zero where no tap reads
    # the plain backward is the gradient of the plain forward
    leaves = [args[0].clone().requires_grad_(True), args[3].clone().requires_grad_(True),
              args[4].clone().requires_grad_(True)]
    out = quad_blend_fwd_reference(leaves[0], args[1], args[2], leaves[1], leaves[2])
    g = torch.autograd.grad((out * torch.from_numpy(ct)).sum(), leaves)
    for a, b in zip(g, (d_win_p, d_ev_p, d_eu_p)):
        assert float((a - b).abs().max()) <= 1e-13


def test_quad_fallback_overflow_raises():
    from torch_port_scenes import TILING, mixed_scene_fields

    # about 4 texels per pixel: most quads span more than the 6 texels of a window
    scene = port.scene_buffers_from_numpy(mixed_scene_fields(tex_hw=(256, 256), uv_scale=240.0), device="cpu")
    tiling = port.TilingConfig(**TILING, tex_tile_capacity=96, tex_block_w=32)
    per_pixel, _, _ = port.render_scene(scene, 0.0, tiling=tiling, check_capacity=True)
    quads, _, _ = port.render_scene(scene, 0.0, tiling=tiling._replace(quad_fallback_capacity=512),
                                    check_capacity=True)
    assert float((quads - per_pixel).abs().max()) <= 1e-15
    with pytest.raises(RuntimeError, match="quad-fetch fallback compaction overflow"):
        port.render_scene(scene, 0.0, tiling=tiling._replace(quad_fallback_capacity=1), check_capacity=True)


def test_scene3d_quad_render_and_backward_match_jax(monkeypatch):
    check_scene3d_render_and_backward(monkeypatch, 1.0, True)
