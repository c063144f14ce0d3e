"""The port's render_scene (deodr_tpu_torch) against the JAX package's
render_scene(..., tiling=..., impl="xla") on the CPU: images, z-buffers,
error buffers and the gradients with respect to ij and colors, at σ = 0 and
σ = 1, image and error mode, in float64 and float32; tie rules; what the
port refused before it had the untiled passes, against JAX, and the
refusals of what it does not cover yet; and no JAX in the port. Textured scenes are
held in tests/test_torch_port_textured.py.

Float64 holds to 1e-9 except at band-boundary pixels: the port's edge
kernel decides band membership with the thresholded planes of
deodr_tpu/ops/pallas/edge_kernel.py:99-114, the XLA path with the rational
x-range form, and the two can disagree for a pixel within a few ulp of a
band boundary. Their number is bounded by MAX_BOUNDARY_PIXELS, and the
gradients are held to 1e-9 for the loss with those pixels left out
(elsewhere both renders agree to 1e-9). Float32 uses the limits of
tests/test_pallas_kernels.py.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deodr_tpu_torch as port
from deodr_tpu.ops.render import _build_edge_data as jax_build_edge_data
from deodr_tpu.ops.render import _culling as jax_culling
from deodr_tpu.ops.render import render_scene as jax_render_scene
from deodr_tpu.ops.render import SceneBuffers as JaxSceneBuffers
from deodr_tpu.ops.tiled import EdgeTexPlan as JaxEdgeTexPlan
from deodr_tpu.ops.tiled import TilingConfig as JaxTilingConfig
from deodr_tpu.ops.tiled import suggest_tiling as jax_suggest_tiling
from deodr_tpu_torch.ops.render import _build_edge_data, _culling, scene_buffers_from_numpy
from examples.triangle_soup_fitting import create_example_scene

SIZE = (96, 128)
TILING = (48, 128, 24, 48)  # tile_h, tile_w, triangle_capacity, edge_capacity
AA_EDGE_CAPACITY = 40
MAX_BOUNDARY_PIXELS = 2
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fields(n_tri=15, seed=4):
    """Untextured triangle soup as numpy SceneBuffers fields; two triangles
    are flipped to face away, so culling and edge compaction take part."""
    np.random.seed(seed)
    scene2d = create_example_scene(n_tri=n_tri, width=SIZE[1], height=SIZE[0], textured_ratio=0.0)
    base = dataclasses.replace(scene2d._buffers(*scene2d._diff_inputs()), texture=None)
    f = {k.name: np.asarray(v) if hasattr(v, "shape") else v
         for k in dataclasses.fields(base) for v in [getattr(base, k.name)]}
    f["faces"] = f["faces"].copy()
    f["faces"][:2] = f["faces"][:2, ::-1]
    return f


def _jax_scene(f, dtype):
    arrays = {k: (jnp.asarray(v, dtype) if np.issubdtype(np.asarray(v).dtype, np.floating) else jnp.asarray(v))
              for k, v in f.items() if isinstance(v, np.ndarray)}
    meta = {k: v for k, v in f.items() if not isinstance(v, np.ndarray)}
    return JaxSceneBuffers(**arrays, **meta)


def _jax_render(f, sigma, error_mode, dtype, tiling=TILING, aa=AA_EDGE_CAPACITY, impl="xla", weight=None):
    """(out, z-buffer, d loss/d ij, d loss/d colors); the loss sums the
    per-pixel error, or squared residual, times ``weight`` (H, W)."""
    scene = _jax_scene(f, dtype)
    obs = jnp.asarray(np.random.RandomState(1).rand(*SIZE, 3), dtype)
    w = jnp.ones(SIZE, dtype) if weight is None else jnp.asarray(weight, dtype)
    t = JaxTilingConfig(*tiling)

    def loss(ij, colors):
        s = dataclasses.replace(scene, ij=ij, colors=colors)
        img, zb, err = jax_render_scene(s, sigma, antialiase_error=error_mode, obs=obs, aa_edge_capacity=aa,
                                        tiling=t, impl=impl, impl_interpret=impl == "pallas")
        out = err if error_mode else img
        return (jnp.sum(err * w) if error_mode else jnp.sum((img - obs) ** 2 * w[..., None])), (out, zb)

    (_, (out, zb)), (g_ij, g_c) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        scene.ij, scene.colors
    )
    return [np.asarray(a) for a in (out, zb, g_ij, g_c)]


def _port_render(f, sigma, error_mode, dtype, tiling=TILING, aa=AA_EDGE_CAPACITY, check_capacity=True,
                 weight=None):
    scene = scene_buffers_from_numpy(f, device="cpu", dtype=dtype)
    obs = torch.from_numpy(np.random.RandomState(1).rand(*SIZE, 3)).to(dtype)
    w = torch.ones(SIZE, dtype=dtype) if weight is None else torch.from_numpy(np.asarray(weight)).to(dtype)
    ij = scene.ij.clone().requires_grad_(True)
    colors = scene.colors.clone().requires_grad_(True)
    s = dataclasses.replace(scene, ij=ij, colors=colors)
    img, zb, err = port.render_scene(s, sigma, antialiase_error=error_mode, obs=obs, aa_edge_capacity=aa,
                                     tiling=port.TilingConfig(*tiling), check_capacity=check_capacity)
    out = err if error_mode else img
    loss = (err * w).sum() if error_mode else ((img - obs) ** 2 * w[..., None]).sum()
    g_ij, g_c = torch.autograd.grad(loss, (ij, colors))
    return [a.detach().numpy() for a in (out, zb, g_ij, g_c)]


def _rel(a, b):
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


@pytest.mark.parametrize("sigma", [0.0, 1.0])
@pytest.mark.parametrize("error_mode", [False, True])
def test_render_matches_jax_f64(sigma, error_mode):
    f = _fields()
    out_j, zb_j, gij_j, gc_j = _jax_render(f, sigma, error_mode, jnp.float64)
    out_p, zb_p, gij_p, gc_p = _port_render(f, sigma, error_mode, torch.float64)
    fin = np.isfinite(zb_j)
    np.testing.assert_array_equal(fin, np.isfinite(zb_p))
    assert np.abs(zb_j[fin] - zb_p[fin]).max() <= 1e-9
    diff = np.abs(out_j - out_p)
    boundary = diff.reshape(SIZE[0], SIZE[1], -1).max(axis=-1) > 1e-9
    assert int(boundary.sum()) <= MAX_BOUNDARY_PIXELS
    if boundary.any():
        # gradients of the same loss with the boundary pixels left out
        keep = (~boundary).astype(np.float64)
        _, _, gij_j, gc_j = _jax_render(f, sigma, error_mode, jnp.float64, weight=keep)
        _, _, gij_p, gc_p = _port_render(f, sigma, error_mode, torch.float64, weight=keep)
    assert _rel(gij_p, gij_j) <= 1e-9
    assert _rel(gc_p, gc_j) <= 1e-9
    assert np.isfinite(gij_p).all() and np.abs(gij_p).max() > 0


@pytest.mark.parametrize("sigma", [0.0, 1.0])
@pytest.mark.parametrize("error_mode", [False, True])
def test_render_matches_jax_f32(sigma, error_mode):
    f = _fields()
    out_j, zb_j, gij_j, gc_j = _jax_render(f, sigma, error_mode, jnp.float32)
    out_p, zb_p, gij_p, gc_p = _port_render(f, sigma, error_mode, torch.float32)
    fin = np.isfinite(zb_j)
    np.testing.assert_array_equal(fin, np.isfinite(zb_p))
    assert np.abs(zb_j[fin] - zb_p[fin]).max() < 1e-5
    assert np.abs(out_j - out_p).max() < (1e-3 if error_mode else 1e-4)
    for g_p, g_j in ((gij_p, gij_j), (gc_p, gc_j)):
        assert np.abs(g_p - g_j).max() < 1e-3 * max(np.abs(g_j).max(), 1.0)


def test_bench_scene_and_tiling_match_jax():
    """suggest_tiling (numpy) plans the same TilingConfig, and the shrunk
    bench scene renders the same, at the production 48×128 tiles."""
    import bench

    s = bench.build_scene(*SIZE, n_tri=12, dtype=jnp.float64)
    kw = dict(sigma=1.0, edgeflags=np.ones((12, 3), bool), margin=1.0, for_pallas=True, bucket_mode="exact")
    t_j = jax_suggest_tiling(np.asarray(s.ij), np.asarray(s.faces), *SIZE, **kw)
    t_p = port.suggest_tiling(np.asarray(s.ij), np.asarray(s.faces), *SIZE, **kw)
    assert t_p._asdict() == {k: getattr(t_j, k) for k in port.TilingConfig._fields} and t_p.tile_h == 48
    f = {k.name: np.asarray(v) if hasattr(v, "shape") else v for k in dataclasses.fields(s) for v in [getattr(s, k.name)]}
    out_j, zb_j, gij_j, _ = _jax_render(f, 1.0, False, jnp.float64, tiling=tuple(t_j)[:4], aa=30)
    out_p, zb_p, gij_p, _ = _port_render(f, 1.0, False, torch.float64, tiling=tuple(t_p)[:4], aa=30,
                                         check_capacity=False)
    assert np.abs(out_j - out_p).max() <= 1e-9
    assert _rel(gij_p, gij_j) <= 1e-9


def test_bench_scene_fields_match_bench():
    """The port's numpy bench scene is bench.build_scene's, field for field."""
    import bench
    from deodr_tpu_torch.bench_scene import bench_scene_fields

    s = bench.build_scene(*SIZE, n_tri=12, dtype=jnp.float32)
    f = bench_scene_fields(*SIZE, n_tri=12)
    assert set(f) == {k.name for k in dataclasses.fields(s)}
    for k, v in f.items():
        ref = getattr(s, k)
        if isinstance(v, np.ndarray):
            assert v.dtype == np.asarray(ref).dtype, k
            np.testing.assert_array_equal(v, np.asarray(ref), err_msg=k)
        else:
            assert v == ref, k


def test_drawn_compaction_and_edge_tile_height_match_jax():
    """TilingConfig.drawn_capacity (culled triangles compacted away before
    binning) and a taller edge-pass tile (edge_tile_h) render as in JAX.

    Held against the JAX Pallas path (interpret mode): its XLA tiled path
    takes the corner colors from the uncompacted faces when drawn_capacity
    is set (deodr_tpu/ops/tiled.py:807), so there the colors of compacted
    triangles are wrong; ROADMAP.md section C records it."""
    f = _fields()
    tiling = (48, 128, 24, 64, 16, 96)  # ..., edge_capacity, drawn_capacity, edge_tile_h
    out_j, zb_j, gij_j, gc_j = _jax_render(f, 1.0, False, jnp.float64, tiling=tiling, impl="pallas")
    out_p, zb_p, gij_p, gc_p = _port_render(f, 1.0, False, torch.float64, tiling=tiling)
    assert np.abs(out_j - out_p).max() <= 1e-9
    assert _rel(gij_p, gij_j) <= 1e-9 and _rel(gc_p, gc_j) <= 1e-9
    with pytest.raises(RuntimeError, match="drawn-triangle compaction overflow"):
        _port_render(f, 0.0, False, torch.float64, tiling=(48, 128, 24, 64, 4))


def _tie_fields():
    """Two coplanar triangles at equal depth, overlapping, different colors,
    plus a third whose depth sum ties with neither."""
    tri = np.array(
        [[[10, 10], [70, 12], [20, 60]], [[15, 14], [80, 20], [30, 70]], [[60, 40], [110, 45], [70, 90]]], np.float64
    )
    # off the pixel lattice, so that no pixel center lies exactly on an edge
    # (where any rounding difference flips the side); front-facing for
    # clockwise=False
    tri = tri[:, [0, 2, 1]] + [0.37, 0.21]
    faces = np.arange(9).reshape(3, 3)
    colors = np.repeat(np.array([[1.0, 0, 0], [0, 1.0, 0], [0, 0, 1.0]]), 3, axis=0)
    return dict(
        faces=faces, faces_uv=faces, ij=tri.reshape(-1, 2), depths=np.array([2.0] * 6 + [1.0] * 3),
        uv=np.zeros((9, 2)), shade=np.zeros(9), colors=colors, edgeflags=np.ones((3, 3), bool),
        textured=np.zeros(3, bool), shaded=np.zeros(3, bool), texture=None,
        background_image=None, background_color=np.array([0.1, 0.2, 0.3]),
        height=SIZE[0], width=SIZE[1], clockwise=False, backface_culling=True, strict_edge=True,
        perspective_correct=False, integer_pixel_centers=True,
    )


def test_ties_lower_index_wins_and_edge_order():
    f = _tie_fields()
    out_p, zb_p, _, _ = _port_render(f, 0.0, False, torch.float64)
    # (25, 30) is inside both equal-depth triangles: triangle 0 (red) wins
    assert abs(zb_p[30, 25] - 2.0) <= 1e-12
    np.testing.assert_allclose(out_p[30, 25], [1.0, 0.0, 0.0], rtol=0, atol=1e-12)
    out_j, zb_j, _, _ = _jax_render(f, 0.0, False, jnp.float64)
    np.testing.assert_allclose(zb_p, zb_j, rtol=0, atol=1e-9)
    assert np.abs(out_p - out_j).max() <= 1e-9
    # back-to-front edge order: equal depth sums keep the lower index first
    scene = scene_buffers_from_numpy(f, device="cpu")
    e_p = _build_edge_data(scene, scene.ij, _culling(scene))
    js = _jax_scene(f, jnp.float64)
    e_j = jax_build_edge_data(js, js.ij, jax_culling(js))
    np.testing.assert_array_equal(e_p.v0.numpy(), np.asarray(e_j.v0))
    np.testing.assert_array_equal(e_p.active.numpy(), np.asarray(e_j.active))
    assert (e_p.v0[:3] == scene.ij[[1, 2, 0]]).all()  # triangle 0's edges come first
    out_j1, _, _, _ = _jax_render(f, 1.0, False, jnp.float64)
    out_p1, _, _, _ = _port_render(f, 1.0, False, torch.float64)
    assert np.abs(out_p1 - out_j1).max() <= 1e-9


def test_check_capacity_raises_on_undersized_tiling():
    f = _fields()
    with pytest.raises(RuntimeError, match="solid tile bin overflow"):
        _port_render(f, 0.0, False, torch.float64, tiling=(48, 128, 2, 48))
    with pytest.raises(RuntimeError, match="edge tile bin overflow"):
        _port_render(f, 1.0, False, torch.float64, tiling=(48, 128, 24, 2))
    with pytest.raises(RuntimeError, match="AA edge compaction overflow"):
        _port_render(f, 1.0, False, torch.float64, aa=3)
    # without the check, overflowing bins drop entries silently, as in JAX
    _port_render(f, 0.0, False, torch.float64, tiling=(48, 128, 2, 48), check_capacity=False)


@pytest.mark.parametrize("change", ["pair", "super"])
def test_off_slice_options_raise(change):
    """The large-mesh binners (pair expansion, supertiles) belong to a
    later part of the port and raise."""
    scene = scene_buffers_from_numpy(_fields(), device="cpu")
    tiling = port.TilingConfig(*TILING)
    if change == "pair":
        tiling = tiling._replace(pair_ry=2, pair_rx=2)
    else:
        tiling = tiling._replace(super_ty=1, super_tx=1, super_capacity=8)
    with pytest.raises(NotImplementedError):
        port.render_scene(scene, 1.0, tiling=tiling)


def _jax_render_with(f, sigma, dtype, **kwargs):
    """(image, z-buffer, d loss/d ij, d loss/d colors) of the JAX
    render_scene with ``kwargs``; the loss is Σ (image − obs)²."""
    scene = _jax_scene(f, dtype)
    obs = jnp.asarray(np.random.RandomState(1).rand(*SIZE, 3), dtype)

    def loss(ij, colors):
        img, zb, _ = jax_render_scene(dataclasses.replace(scene, ij=ij, colors=colors), sigma, **kwargs)
        return jnp.sum((img - obs) ** 2), (img, zb)

    (_, (img, zb)), (g_ij, g_c) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(scene.ij,
                                                                                                  scene.colors)
    return [np.asarray(a) for a in (img, zb, g_ij, g_c)]


@pytest.mark.parametrize(
    "change", ["untiled", "texture", "perspective_correct", "strict_edge", "aa_window", "aa_tex_plan", "aa_tex_window"]
)
def test_former_off_slice_options_render_as_jax(change):
    """What the port refused before it had the untiled passes now renders
    as the JAX package does, at σ = 1 in float64 (image, z-buffer and the
    gradients to ij and colors within 1e-9): the untiled route, a textured
    scene without a texture plan ("texture"; a zero texture no triangle
    uses), perspective correction, ``strict_edge=False``, the sequential
    pass's windows, and a textured perspective-correct scene with a plan
    ("aa_tex_plan"), which takes the sequential pass. The tiled cases are
    held against the JAX Pallas route (interpret mode), whose edge kernel
    clips bands as the port's does; the perspective-correct tiled cases'
    gradients against the JAX untiled route (the JAX tiled routes give NaN
    gradients there, tests/test_torch_port_modes.py)."""
    f = dict(_fields())
    tiling = TILING
    port_kw, jax_kw = {}, {}
    if change == "untiled":
        tiling = None
    elif change == "texture":
        f.update(texture=np.zeros((4, 4, 3)))
    elif change == "perspective_correct":
        f.update(perspective_correct=True)
    elif change == "strict_edge":
        # tilted in depth: non-strict, a triangle clipped at the frame's border covers pixels beside its own
        # bands, and at equal depths their z-test would be decided by the last bit (test_torch_port_untiled.py)
        f.update(strict_edge=False, depths=f["depths"] + 0.5 * np.random.RandomState(7).rand(len(f["depths"])))
    elif change == "aa_window":
        tiling = None
        port_kw = jax_kw = dict(aa_window=(32, 32))
    elif change == "aa_tex_window":
        tiling = None
        port_kw = jax_kw = dict(aa_tex_window=(16, 16))
    else:
        f.update(texture=np.zeros((4, 4, 3)), perspective_correct=True)
        port_kw, jax_kw = dict(aa_tex_plan=port.EdgeTexPlan()), dict(aa_tex_plan=JaxEdgeTexPlan())
    jax_tiling = None if tiling is None else JaxTilingConfig(*tiling)
    want = _jax_render_with(f, 1.0, jnp.float64, aa_edge_capacity=AA_EDGE_CAPACITY, tiling=jax_tiling,
                            impl="pallas", impl_interpret=True, **jax_kw)
    if f["perspective_correct"] and tiling is not None:
        want[2:] = _jax_render_with(f, 1.0, jnp.float64, aa_edge_capacity=AA_EDGE_CAPACITY, **jax_kw)[2:]
    scene = scene_buffers_from_numpy(f, device="cpu")
    obs = torch.from_numpy(np.random.RandomState(1).rand(*SIZE, 3))
    ij, colors = scene.ij.clone().requires_grad_(True), scene.colors.clone().requires_grad_(True)
    img, zb, _ = port.render_scene(dataclasses.replace(scene, ij=ij, colors=colors), 1.0,
                                   aa_edge_capacity=AA_EDGE_CAPACITY,
                                   tiling=None if tiling is None else port.TilingConfig(*tiling), **port_kw)
    g_ij, g_c = torch.autograd.grad(((img - obs) ** 2).sum(), (ij, colors))
    img_j, zb_j, gij_j, gc_j = want
    fin = np.isfinite(zb_j)
    np.testing.assert_array_equal(fin, np.isfinite(zb.numpy()))
    assert np.abs(zb.numpy()[fin] - zb_j[fin]).max() <= 1e-9
    assert np.abs(img.detach().numpy() - img_j).max() <= 1e-9
    assert _rel(g_ij.numpy(), gij_j) <= 1e-9 and _rel(g_c.numpy(), gc_j) <= 1e-9


def test_cuda_request_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        scene_buffers_from_numpy(_fields())


def test_port_and_chip_smoke_import_no_jax():
    code = (
        "import sys; import deodr_tpu_torch, deodr_tpu_torch.ops.tiled, deodr_tpu_torch.bench_scene, chip_smoke; "
        "import deodr_tpu_torch.duck_scene, deodr_tpu_torch.io.obj, deodr_tpu_torch.ops.kernels.edge_tex_kernel; "
        "import deodr_tpu_torch.scene, deodr_tpu_torch.ops.kernels.quad_blend_kernel; "
        "import deodr_tpu_torch.ops.edge_aa, deodr_tpu_torch.ops.raster, deodr_tpu_torch.ops.common; "
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'deodr_tpu.')) or m == 'deodr_tpu']; "
        "assert not bad, bad"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, check=True, timeout=120)
