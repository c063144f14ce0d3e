"""The port's textured rendering (deodr_tpu_torch) against the JAX package on
the CPU, inputs made from a seed with numpy and fed to both:

- ``bilinear_sample``: values and gradients to uv and texture, with samples
  outside every border and on integer texels;
- ``split_edges`` and ``compact_active_edges`` field by field (exact);
- the whole ``render_scene`` in float32 against
  ``deodr_tpu.ops.render.render_scene(..., impl="pallas",
  impl_interpret=True, aa_tex_plan=...)`` on the mixed scene of
  tests/test_edge_tex_pallas.py (96×128, 12 triangles, 64² texture,
  σ = 1.5), image and error mode, unsplit and split plans: image within
  1e-4, gradients to ij, colors, uv, shade and texture within 1e-3 of their
  scale (tests/test_torch_port_textured_render.py holds float64);
- the plain backward of the textured edge pass against autograd through its
  plain forward (float64, 1e-9 of scale).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deodr_tpu_torch as port
from deodr_tpu.ops.common import bilinear_sample as jax_bilinear_sample
from deodr_tpu.ops.render import SceneBuffers as JaxSceneBuffers
from deodr_tpu.ops.render import _build_edge_data as jax_build_edge_data
from deodr_tpu.ops.render import _culling as jax_culling
from deodr_tpu.ops.render import render_scene as jax_render_scene
from deodr_tpu.ops.tiled import EdgeTexPlan as JaxEdgeTexPlan
from deodr_tpu.ops.tiled import TilingConfig as JaxTilingConfig
from deodr_tpu.ops.tiled import compact_active_edges as jax_compact_active_edges
from deodr_tpu.ops.tiled import split_edges as jax_split_edges
from deodr_tpu_torch.ops.common import bilinear_sample
from deodr_tpu_torch.ops.kernels import edge_tex_kernel as etk
from deodr_tpu_torch.ops.render import _build_edge_data, prepare, scene_buffers_from_numpy
from deodr_tpu_torch.ops.tiled import compact_active_edges, split_edges
from torch_port_scenes import (
    AA_EDGE_CAPACITY,
    HEIGHT,
    JAX_WINDOW,
    SIGMA,
    TILING,
    WIDTH,
    mixed_scene_fields,
    obs_image,
    plan_scene,
    tex_tables,
)

DIFF = ("ij", "colors", "uv", "shade", "texture")


def _jax_scene(f, dtype):
    arrays = {k: (jnp.asarray(v, dtype) if np.issubdtype(np.asarray(v).dtype, np.floating) else jnp.asarray(v))
              for k, v in f.items() if isinstance(v, np.ndarray)}
    rest = {k: v for k, v in f.items() if not isinstance(v, np.ndarray)}
    return JaxSceneBuffers(**arrays, **rest)


def _weight(shape):
    return np.cos(np.arange(int(np.prod(shape)), dtype=np.float64).reshape(shape))


def _jax_render(f, sigma, error_mode, dtype, plan, tiling=TILING):
    """(out, z-buffer, gradients by name); the loss is Σ out · cos(index)."""
    scene = _jax_scene(f, dtype)
    obs = jnp.asarray(obs_image(), dtype)
    t = JaxTilingConfig(**tiling)
    jplan = None if plan is None else JaxEdgeTexPlan(**JAX_WINDOW, **plan)
    args = tuple(getattr(scene, k) for k in DIFF)

    def loss(*a):
        s = dataclasses.replace(scene, **dict(zip(DIFF, a)))
        img, zb, err = jax_render_scene(s, sigma, antialiase_error=error_mode, obs=obs if error_mode else None,
                                        aa_edge_capacity=AA_EDGE_CAPACITY, tiling=t, impl="pallas",
                                        impl_interpret=True, aa_tex_plan=jplan)
        out = err if error_mode else img
        return jnp.sum(out * jnp.asarray(_weight(out.shape), dtype)), (out, zb)

    (_, (out, zb)), grads = jax.jit(jax.value_and_grad(loss, argnums=tuple(range(len(DIFF))), has_aux=True))(*args)
    return np.asarray(out), np.asarray(zb), {k: np.asarray(g) for k, g in zip(DIFF, grads)}


def _port_render(f, sigma, error_mode, dtype, plan, tiling=TILING, check_capacity=True):
    scene = scene_buffers_from_numpy(f, device="cpu", dtype=dtype)
    obs = torch.from_numpy(obs_image()).to(dtype)
    leaves = {k: getattr(scene, k).clone().requires_grad_(True) for k in DIFF}
    s = dataclasses.replace(scene, **leaves)
    img, zb, err = port.render_scene(
        s, sigma, antialiase_error=error_mode, obs=obs if error_mode else None, aa_edge_capacity=AA_EDGE_CAPACITY,
        tiling=port.TilingConfig(**tiling), aa_tex_plan=None if plan is None else port.EdgeTexPlan(**plan),
        check_capacity=check_capacity,
    )
    out = err if error_mode else img
    loss = (out * torch.from_numpy(_weight(tuple(out.shape))).to(dtype)).sum()
    grads = torch.autograd.grad(loss, [leaves[k] for k in DIFF])
    return out.detach().numpy(), zb.numpy(), {k: g.numpy() for k, g in zip(DIFF, grads)}


# ------------------------------------------------------------ bilinear_sample


def _sample_points(th, tw):
    """Random points over and beyond the texture, every border strip and
    corner, and integer texels (borders included)."""
    rng = np.random.RandomState(5)
    inside = rng.rand(200, 2) * [tw + 4.0, th + 4.0] - 2.0
    outside = np.array([[-3.2, 4.1], [tw + 2.5, 4.1], [4.3, -1.5], [4.3, th + 0.7], [-1.0, -1.0],
                        [tw + 1.0, th + 1.0], [-0.5, th - 0.5], [tw - 0.5, -0.5], [tw - 1.5, th - 1.5]])
    gx, gy = np.meshgrid(np.arange(-1, tw + 1), np.arange(-1, th + 1))
    integer = np.stack([gx.ravel(), gy.ravel()], axis=1).astype(np.float64)
    return np.concatenate([inside, outside, integer])


def test_bilinear_sample_matches_jax():
    th, tw = 7, 9
    rng = np.random.RandomState(6)
    texture = rng.rand(th, tw, 3)
    p = _sample_points(th, tw)
    weight = rng.randn(len(p), 3)

    (val_j, (g_tex_j, g_p_j)) = jax.value_and_grad(
        lambda t, q: jnp.sum(jax_bilinear_sample(t, q) * weight), argnums=(0, 1)
    )(jnp.asarray(texture), jnp.asarray(p))
    out_j = np.asarray(jax_bilinear_sample(jnp.asarray(texture), jnp.asarray(p)))

    tex_t = torch.from_numpy(texture).requires_grad_(True)
    p_t = torch.from_numpy(p).requires_grad_(True)
    out_t = bilinear_sample(tex_t, p_t)
    g_tex_t, g_p_t = torch.autograd.grad((out_t * torch.from_numpy(weight)).sum(), (tex_t, p_t))

    assert np.abs(out_t.detach().numpy() - out_j).max() <= 1e-12
    assert np.abs(g_tex_t.numpy() - np.asarray(g_tex_j)).max() <= 1e-12
    assert np.abs(g_p_t.numpy() - np.asarray(g_p_j)).max() <= 1e-12
    # the sample at an integer texel is that texel; a clamped coordinate has no gradient
    assert np.array_equal(bilinear_sample(tex_t, torch.tensor([[3.0, 2.0]], dtype=torch.float64)).detach().numpy()[0],
                          texture[2, 3])
    out_of_range = (np.floor(p[:, 0]) < 0) | (np.floor(p[:, 0]) > tw - 2)
    assert out_of_range.any() and not g_p_t.numpy()[out_of_range, 0].any()
    assert float(val_j) == pytest.approx(float((out_t.detach() * torch.from_numpy(weight)).sum()), abs=1e-10)


def test_bilinear_sample_nonfinite_coordinates_stay_inside():
    texture = torch.from_numpy(np.random.RandomState(1).rand(4, 5, 2))
    p = torch.tensor([[float("nan"), 1.0], [float("inf"), 1.5], [-float("inf"), 2.0], [1.0, float("nan")]],
                     dtype=torch.float64)
    out = bilinear_sample(texture, p)  # must not raise an index error
    assert out.shape == (4, 2)
    np.testing.assert_allclose(out[1].numpy(), (0.5 * texture[1, 4] + 0.5 * texture[2, 4]).numpy(), atol=1e-12)
    np.testing.assert_allclose(out[2].numpy(), texture[2, 0].numpy(), atol=1e-12)


# ------------------------------------------- split_edges, compact_active_edges


def _edge_fields(e):
    return {k: np.asarray(getattr(e, k)) for k in e._fields}


@pytest.mark.parametrize("plan", ["unsplit", "split"])
def test_edge_data_split_and_compaction_match_jax(plan):
    f, kw = plan_scene(plan)
    f["faces"] = f["faces"].copy()
    f["faces"][:2] = f["faces"][:2, ::-1]  # two back-facing triangles: inactive edges take part
    js = _jax_scene(f, jnp.float64)
    e_j = jax_build_edge_data(js, js.ij, jax_culling(js), AA_EDGE_CAPACITY)
    ps = scene_buffers_from_numpy(f, device="cpu")
    ij_off, signed_area, _, _ = prepare(ps)
    e_p = _build_edge_data(ps, ij_off, signed_area, AA_EDGE_CAPACITY)

    def same(a, b, what):
        fa, fb = {k: getattr(a, k).numpy() for k in a._fields}, _edge_fields(b)
        assert set(fa) == set(fb)
        for k in fa:
            np.testing.assert_array_equal(fa[k], fb[k], err_msg=f"{what}.{k}")

    same(e_p, e_j, "edges")
    n_split = max(kw["n_split"], 4)
    for seg_len, uv_len in ((None, kw.get("uv_segment_length", 12.0)), (9.0, None), (20.0, 6.0)):
        s_j = jax_split_edges(e_j, n_split, seg_len, uv_segment_length=uv_len)
        s_p = split_edges(e_p, n_split, seg_len, uv_segment_length=uv_len)
        same(s_p, s_j, f"split({seg_len}, {uv_len})")
        if seg_len is not None:
            assert s_p.active.sum() > e_p.active.sum()  # some edge was really split
        for cap in (16, 128, 10**6):
            same(compact_active_edges(s_p, cap), jax_compact_active_edges(s_j, cap), f"compact({cap})")
    # an edge that needs one segment keeps its endpoints bit for bit
    one = split_edges(e_p, 4, 1e9)
    assert torch.equal(one.v0[::4], e_p.v0) and torch.equal(one.v1[::4], e_p.v1)
    assert torch.equal(one.uvs[::4], e_p.uvs) and not one.active.reshape(-1, 4)[:, 1:].any()


# ------------------------------------------------------- whole render_scene


@pytest.mark.parametrize("error_mode", [False, True], ids=["image", "error"])
@pytest.mark.parametrize("plan", ["unsplit", "split"])
def test_textured_render_matches_jax_f32(plan, error_mode):
    f, kw = plan_scene(plan)
    out_j, zb_j, g_j = _jax_render(f, SIGMA, error_mode, jnp.float32, kw)
    out_p, zb_p, g_p = _port_render(f, SIGMA, error_mode, torch.float32, kw)
    np.testing.assert_array_equal(np.isfinite(zb_j), np.isfinite(zb_p))
    assert np.abs(out_j - out_p).max() <= 1e-4
    for k in DIFF:
        scale = max(1.0, float(np.abs(g_j[k]).max()))
        assert np.abs(g_p[k] - g_j[k]).max() <= 1e-3 * scale, k


def test_textured_capacity_checks_and_refusals():
    """The segment capacity check fires; a textured scene at σ > 0 without
    a texture plan takes the sequential edge pass, as in the JAX package
    (image against its render of the same call, float64); mismatched
    channels are refused."""
    f, kw = plan_scene("split")
    with pytest.raises(RuntimeError, match="texture-window segment compaction overflow"):
        _port_render(f, SIGMA, False, torch.float64, dict(kw, seg_capacity=8))
    _port_render(f, SIGMA, False, torch.float64, dict(kw, seg_capacity=8), check_capacity=False)
    out_p = _port_render(f, SIGMA, False, torch.float64, None)[0]
    out_j = jax.jit(lambda s: jax_render_scene(s, SIGMA, aa_edge_capacity=AA_EDGE_CAPACITY,
                                               tiling=JaxTilingConfig(**TILING), impl="pallas",
                                               impl_interpret=True)[0])(_jax_scene(f, jnp.float64))
    assert np.abs(out_p - np.asarray(out_j)).max() <= 1e-9
    bad = dict(f, colors=f["colors"][:, :2], background_color=f["background_color"][:2])
    with pytest.raises(ValueError, match="channels"):
        _port_render(bad, 0.0, False, torch.float64, None)


# ------------------------------------------------ the kernel's plain versions


@pytest.mark.parametrize("error_mode", [False, True], ids=["image", "error"])
@pytest.mark.parametrize("plan", ["unsplit", "split", "clamped"])
def test_edge_tex_plain_backward_matches_autograd_f64(plan, error_mode):
    et, texture, buf, z_pad, obs_pad = tex_tables(plan, error_mode)
    c = 3
    assert et.table_tile.shape[2] == etk.tex_row_width(c)
    use_tex = et.table_tile[:, :, etk._e_utex(c)] > 0.5
    live = torch.arange(et.table_tile.shape[1])[None, :] < et.counts[:, None]
    assert (use_tex & live).any() and (~use_tex & live).any()  # mixed slots
    table = et.table_tile.detach().clone().requires_grad_(True)
    tex = texture.detach().clone().requires_grad_(True)
    buf0 = buf.detach().clone().requires_grad_(True)
    out = etk.edge_tex_fwd_reference(table, tex, buf0, z_pad, obs_pad, et.counts, et.grid, error_mode)
    g_out = torch.from_numpy(np.random.RandomState(6).randn(*out.shape))
    g_table, g_tex, g_buf = torch.autograd.grad((out * g_out).sum(), (table, tex, buf0))
    g_rows, g_buf0, g_texture = etk.edge_tex_bwd_reference(
        et.table_tile, texture, out.detach(), z_pad, obs_pad, g_out, et.counts, et.grid, error_mode
    )
    differentiable = list(range(16, 19)) + list(range(21, 21 + 3 * c)) + list(range(25 + 3 * c, 34 + 3 * c))
    g_auto = g_table[:, :, differentiable]
    for name, auto, plain in (("rows", g_auto, g_rows), ("buffer", g_buf, g_buf0), ("texture", g_tex, g_texture)):
        scale = float(auto.abs().max())
        assert scale > 0, name
        assert float((auto - plain).abs().max()) <= 1e-9 * scale, name
    others = [j for j in range(g_table.shape[2]) if j not in differentiable]
    assert not g_table[:, :, others].any()
    # the autograd.Function wires the same numbers through
    table2 = et.table_tile.detach().clone().requires_grad_(True)
    tex2 = texture.detach().clone().requires_grad_(True)
    out2 = etk.edge_tex_pass(table2, tex2, buf, z_pad, obs_pad, et.counts, et.grid, error_mode)
    g_table2, g_tex2 = torch.autograd.grad((out2 * g_out).sum(), (table2, tex2))
    assert torch.equal(out2, out.detach())
    assert float((g_table2 - g_table).abs().max()) <= 1e-9 * float(g_table.abs().max())
    assert float((g_tex2 - g_tex).abs().max()) <= 1e-9 * float(g_tex.abs().max())


@pytest.mark.parametrize("error_mode", [False, True], ids=["image", "error"])
def test_edge_tex_plain_versions_ignore_the_unused_branch(error_mode):
    """A plain slot's uv and shade coefficients and a textured slot's colour
    planes are never read by the kernel; NaN there must change neither the
    plain versions' results nor make a gradient non-finite."""
    et, texture, buf, z_pad, obs_pad = tex_tables("split", error_mode)
    c = 3
    use_tex = et.table_tile[:, :, etk._e_utex(c)] > 0.5
    poisoned = et.table_tile.clone()
    poisoned[:, :, etk._e_uc(c) : etk._e_uc(c) + 9][~use_tex] = float("nan")
    poisoned[:, :, 21 : 21 + 3 * c][use_tex] = float("nan")
    assert etk.textured_visits(et.table_tile, z_pad, et.counts, et.grid) > 0
    assert etk.textured_visits(poisoned, z_pad, et.counts, et.grid) == etk.textured_visits(
        et.table_tile, z_pad, et.counts, et.grid
    )
    want = etk.edge_tex_fwd_reference(et.table_tile, texture, buf, z_pad, obs_pad, et.counts, et.grid, error_mode)
    table = poisoned.clone().requires_grad_(True)
    tex = texture.detach().clone().requires_grad_(True)
    out = etk.edge_tex_fwd_reference(table, tex, buf, z_pad, obs_pad, et.counts, et.grid, error_mode)
    assert torch.equal(out.detach(), want)
    g_out = torch.from_numpy(np.random.RandomState(6).randn(*out.shape))
    g_table, g_tex = torch.autograd.grad((out * g_out).sum(), (table, tex))
    assert bool(torch.isfinite(g_table).all()) and bool(torch.isfinite(g_tex).all())
    clean = etk.edge_tex_bwd_reference(et.table_tile, texture, want, z_pad, obs_pad, g_out, et.counts, et.grid,
                                       error_mode)
    got = etk.edge_tex_bwd_reference(poisoned, texture, want, z_pad, obs_pad, g_out, et.counts, et.grid, error_mode)
    for a, b in zip(got, clean):
        assert torch.equal(a, b)
    assert float((g_tex - clean[2]).abs().max()) <= 1e-9 * float(clean[2].abs().max())


def test_edge_tex_wrappers_check_inputs():
    et, texture, buf, z_pad, obs_pad = tex_tables("unsplit", False)
    with pytest.raises(ValueError, match="impl"):
        etk.edge_tex_fwd(et.table_tile, texture, buf, z_pad, obs_pad, et.counts, et.grid, False, impl="pallas")
    with pytest.raises(ValueError, match="row width"):
        etk._check_inputs(et.table_tile[:, :, :-1], texture, buf, z_pad, obs_pad, et.counts, et.grid, False)
    with pytest.raises(ValueError, match="CUDA"):
        etk._check_inputs(et.table_tile, texture, buf, z_pad, obs_pad, et.counts, et.grid, False)
