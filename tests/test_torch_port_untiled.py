"""The port's untiled renderer (deodr_tpu_torch) against the JAX package's
on the CPU: ``render_scene(tiling=None)`` — ``find_winners`` and
``shade_pixels``, then the sequential edge pass, full-frame or in
``aa_window`` windows — at σ = 0 and σ = 1.5, image and error mode, with
and without ``strict_edge`` and perspective correction, on the mixed
textured / plain soup of tests/torch_port_scenes.py and its untextured
twin; ``Scene3D`` on a 192-face torus (no tiling: render, backward and
depth); ``validate_capacities``; and the reference's pixel-centre and texel
convention cases on the untiled route.

Images, z-buffers and the gradients to ij, colors, uv, shade, texture,
depths and the background color are held to 1e-9 (of their scale) in
float64, and to 1e-4 (image), 1e-5 (z) and 1e-3 of scale (gradients) in
float32. The soup's triangles are tilted in depth (``tilt``): with
``strict_edge=False`` a triangle clipped at the frame's border covers pixels
beside its own bands, and at equal depths their z-test would be decided by
the last bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import checkify

import deodr_tpu_torch as port
from deodr_tpu.ops.render import SceneBuffers as JaxSceneBuffers
from deodr_tpu.ops.render import render_scene as jax_render_scene
from deodr_tpu.ops.render import validate_capacities as jax_validate_capacities
from deodr_tpu_torch.ops.render import CAPACITY_CLASSES, scene_buffers_from_numpy
from deodr_tpu_torch.scene import Scene3D
from torch_port_scenes import HEIGHT, WIDTH, mixed_scene_fields

SIGMA = 1.5
WINDOWS = dict(aa_window=(64, 128), aa_tex_window=(16, 16))


def soup(textured=True, strict=True, persp=False):
    """The mixed soup (12 triangles, 96×128, tilted in depth) as numpy
    fields; without ``textured`` no texture and no textured triangle."""
    f = dict(mixed_scene_fields(tilt=0.5), strict_edge=strict, perspective_correct=persp)
    if not textured:
        f.update(texture=None, textured=np.zeros_like(f["textured"]))
    return f


def _names(f):
    names = ["ij", "colors", "depths", "background_color"]
    return names + (["uv", "shade", "texture"] if f["texture"] is not None else [])


def _weight(shape):
    return np.cos(np.arange(int(np.prod(shape)), dtype=np.float64)).reshape(shape)


def jax_render(f, sigma, error_mode, dtype=jnp.float64, **kwargs):
    """(out, z-buffer, gradients by name) of the JAX render_scene, the loss
    Σ out · weight."""
    arrays = {k: (jnp.asarray(v, dtype) if np.issubdtype(np.asarray(v).dtype, np.floating) else jnp.asarray(v))
              for k, v in f.items() if isinstance(v, np.ndarray)}
    scene = JaxSceneBuffers(**arrays, **{k: v for k, v in f.items() if not isinstance(v, np.ndarray)})
    obs = jnp.asarray(np.random.RandomState(1).rand(HEIGHT, WIDTH, 3), dtype)
    names = _names(f)

    def loss(*leaves):
        s = dataclasses.replace(scene, **dict(zip(names, leaves)))
        img, zb, err = jax_render_scene(s, sigma, antialiase_error=error_mode, obs=obs, **kwargs)
        out = err if error_mode else img
        return jnp.sum(out * jnp.asarray(_weight(out.shape), dtype)), (out, zb)

    grad = jax.value_and_grad(loss, argnums=tuple(range(len(names))), has_aux=True)
    (_, (out, zb)), grads = jax.jit(grad)(*[getattr(scene, k) for k in names])
    return np.asarray(out), np.asarray(zb), {k: np.asarray(g) for k, g in zip(names, grads)}


def port_render(f, sigma, error_mode, dtype=torch.float64, **kwargs):
    """The port's counterpart of :func:`jax_render`."""
    scene = scene_buffers_from_numpy(f, device="cpu", dtype=dtype)
    obs = torch.from_numpy(np.random.RandomState(1).rand(HEIGHT, WIDTH, 3)).to(dtype)
    names = _names(f)
    leaves = {k: getattr(scene, k).clone().requires_grad_(True) for k in names}
    img, zb, err = port.render_scene(dataclasses.replace(scene, **leaves), sigma, antialiase_error=error_mode,
                                     obs=obs, **kwargs)
    out = err if error_mode else img
    grads = torch.autograd.grad((out * torch.from_numpy(_weight(out.shape)).to(dtype)).sum(), list(leaves.values()),
                                allow_unused=True)
    grads = {k: np.zeros(tuple(leaves[k].shape)) if g is None else g.numpy() for k, g in zip(names, grads)}
    return out.detach().numpy(), zb.numpy(), grads


def assert_close(port_out, jax_out, f64=True, grads_from=None):
    """Image (or error buffer), z-buffer and gradients within the bounds of
    the module docstring; ``grads_from`` gives the reference gradients
    where they come from another JAX route."""
    out_p, zb_p, g_p = port_out
    out_j, zb_j, g_j = jax_out
    if grads_from is not None:
        g_j = grads_from[2]
    fin = np.isfinite(zb_j)
    assert fin.sum() > 1000
    np.testing.assert_array_equal(fin, np.isfinite(zb_p))
    assert np.abs(zb_p[fin] - zb_j[fin]).max() <= (1e-9 if f64 else 1e-5)
    assert np.abs(out_p - out_j).max() <= (1e-9 if f64 else 1e-4)
    assert set(g_p) == set(g_j)
    for k in g_j:
        scale = max(1.0, float(np.abs(g_j[k]).max()))
        assert np.isfinite(g_p[k]).all(), k
        assert np.abs(g_p[k] - g_j[k]).max() <= (1e-9 if f64 else 1e-3) * scale, k
    assert np.abs(g_p["ij"]).max() > 0


# (sigma, error mode, strict_edge, perspective_correct, textured, windows)
UNTILED = {
    "s0-image": (0.0, False, True, False, True, False),
    "s1-image": (SIGMA, False, True, False, True, False),
    "s1-error-persp-windows": (SIGMA, True, True, True, True, True),
    "s1-image-nonstrict-persp-plain": (SIGMA, False, False, True, False, False),
    "s1-error-nonstrict": (SIGMA, True, False, False, True, False),
    "s1-image-nonstrict-persp-windows": (SIGMA, False, False, True, True, True),
    "s1-error-plain-windows": (1.0, True, True, False, False, True),
}


@pytest.mark.parametrize("case", list(UNTILED))
def test_untiled_render_matches_jax_f64(case):
    sigma, error_mode, strict, persp, textured, windows = UNTILED[case]
    f = soup(textured, strict, persp)
    kwargs = WINDOWS if windows else {}
    assert_close(port_render(f, sigma, error_mode, **kwargs), jax_render(f, sigma, error_mode, **kwargs))


@pytest.mark.parametrize("case", ["s1-image", "s1-image-nonstrict-persp-plain"])
def test_untiled_render_matches_jax_f32(case):
    sigma, error_mode, strict, persp, textured, windows = UNTILED[case]
    f = soup(textured, strict, persp)
    assert_close(port_render(f, sigma, error_mode, torch.float32), jax_render(f, sigma, error_mode, jnp.float32),
                 f64=False)


def test_windows_equal_the_full_pass_where_they_hold():
    """The windowed sequential pass is the full-frame one wherever the
    windows hold the bands, in the image and in every gradient."""
    f = soup(True, True, True)
    full = port_render(f, SIGMA, False)
    windowed = port_render(f, SIGMA, False, **WINDOWS)
    assert_close(windowed, full)


def test_validate_capacities_counts_match_jax():
    """validate_capacities' counts are the JAX package's: each equals the
    capacity at which the JAX checks start to fire, and the port raises for
    the same class at that capacity."""
    f = soup(True, True, False)
    kw = dict(tile_h=16, tile_w=128, edge_tile_h=8, super_shape=(2, 1), tex_block_w=32, uv_segment_length=2.0,
              uv_n_split=4)
    scene = scene_buffers_from_numpy(f, device="cpu")
    counts, ok = port.validate_capacities(scene, SIGMA, [1 << 30] * 7, **kw)
    assert ok and all(counts[k] > 0 for k in CAPACITY_CLASSES)
    arrays = {k: jnp.asarray(v) for k, v in f.items() if isinstance(v, np.ndarray)}
    js = JaxSceneBuffers(**arrays, **{k: v for k, v in f.items() if not isinstance(v, np.ndarray)})
    check = jax.jit(checkify.checkify(lambda caps: jax_validate_capacities(js, SIGMA, caps, **kw)))
    exact = [counts[k] for k in CAPACITY_CLASSES]
    err, _ = check(jnp.asarray(exact, jnp.int32))
    assert err.get() is None
    for i, label in enumerate(CAPACITY_CLASSES):
        caps = list(exact)
        caps[i] -= 1
        err, _ = check(jnp.asarray(caps, jnp.int32))
        assert err.get() is not None and label in err.get(), label
        with pytest.raises(RuntimeError, match=f"{label} overflow"):
            port.validate_capacities(scene, SIGMA, caps, **kw)
        assert port.validate_capacities(scene, SIGMA, caps, raise_on_overflow=False, **kw)[1] is False


# ------------------------------------------------- Scene3D without tiling


@pytest.mark.parametrize("kind", ["textured", "untextured", "depth"])
def test_scene3d_untiled_matches_jax(kind):
    """Scene3D on the torus at n = 8, m = 12 (192 faces: no tiling), σ = 1:
    the plan (aa_edge_capacity and the windows) equals the JAX planner's,
    and render + render_backward (or render_depth + its backward) match the
    JAX Scene3D path."""
    from test_torch_port_scene3d import _assert_plans_equal, _cameras, _meshes, _scenes, check_scene3d_against_jax

    textured = kind == "textured"
    kwargs = dict(n=8, m=12) if not textured else dict(n=8, m=12, tex_size=64, uv_step=(3.5, 4.5))
    mesh_p, mesh_j = _meshes(textured, **kwargs)
    assert mesh_p.nb_faces == 192
    scene_p, scene_j = _scenes(mesh_p, mesh_j, 1.0)
    depth_scale = 0.5 if kind == "depth" else None
    if depth_scale is not None:
        for s in (scene_p, scene_j):
            s.background_color = np.array([5.0])
    camera_p, camera_j = _cameras()
    plan = scene_p._eager_plan(camera_p)
    _assert_plans_equal(plan, scene_j._eager_plan(camera_j))
    assert plan[1] is None  # untiled (the window would cover more than a quarter of this frame)
    g = check_scene3d_against_jax(scene_p, scene_j, camera_p, camera_j, depth_scale=depth_scale, min_covered=1500)
    assert np.abs(g["vertices"]).max() > 0
    if textured:
        assert np.abs(g["texture"]).max() > 0 and np.abs(g["uv"]).max() > 0


def test_scene3d_brute_renders_untiled():
    """impl="brute" plans no tiling on any mesh, as in the JAX package, and
    renders as the tiled plan does at σ = 0 (the same coverage rule)."""
    from test_torch_port_scene3d import LIGHT, _cameras, _meshes

    mesh_p, _ = _meshes(False)
    camera, _ = _cameras()
    images = []
    for impl in ("brute", "kernel"):
        scene = Scene3D(sigma=0.0, device="cpu", impl=impl)
        scene.set_mesh(mesh_p)
        scene.set_light(*LIGHT)
        scene.set_background_color(np.zeros(3))
        assert (scene._eager_plan(camera)[1] is None) == (impl == "brute")
        images.append(scene.render(camera))
    assert float((images[0] - images[1]).abs().max()) <= 1e-9


# ------------------------------------------- the reference's conventions


def _one_triangle(ij, faces, clockwise, **fields):
    f = dict(faces=np.asarray(faces), faces_uv=np.asarray(faces), ij=np.asarray(ij, np.float64),
             depths=np.ones(3), edgeflags=np.zeros((1, 3), bool), shaded=np.zeros(1, bool), textured=np.zeros(1, bool),
             shade=np.ones(3), background_image=None, strict_edge=False, perspective_correct=True, clockwise=clockwise,
             backface_culling=True)
    f.update(fields)
    return scene_buffers_from_numpy(f, device="cpu")


@pytest.mark.parametrize("integer_pixel_centers", [False, True])
def test_pixel_center_coordinates_untiled(integer_pixel_centers):
    """tests/test_pixel_center_conventions.py on render_scene(tiling=None):
    a tiny triangle around each image corner lights exactly that pixel."""
    height, width = 4, 3
    eps = 0.001
    for px, py in [(0, 0), (width - 1, 0), (0, height - 1), (width - 1, height - 1)]:
        point = (px, py) if integer_pixel_centers else (px + 0.5, py + 0.5)
        ij = np.array([[-eps, -eps], [-eps, eps], [eps, -eps]]) + np.array(point, np.float64)
        scene = _one_triangle(ij, [[0, 2, 1]], True, uv=np.zeros((3, 2)), texture=np.ones((2, 2, 1)),
                              colors=np.ones((3, 1)), background_color=np.zeros(1), height=height, width=width,
                              integer_pixel_centers=integer_pixel_centers)
        image, _, _ = port.render_scene(scene, 0.0)
        expected = np.zeros((height, width, 1))
        expected[py, px, 0] = 1
        np.testing.assert_allclose(image.numpy(), expected, atol=1e-12)


@pytest.mark.parametrize("clockwise", [False, True])
def test_texture_coordinates_untiled(clockwise):
    """tests/test_texture_conventions.py on render_scene(tiling=None):
    integer texel centres, origin at the upper left."""
    texture = np.array([[[1, 0, 0], [0, 1, 0]], [[0, 0, 1], [1, 1, 1]]], dtype=np.float64)
    faces = [[0, 2, 1]] if clockwise else [[0, 1, 2]]
    scene = _one_triangle([[1, 1], [1, 15], [15, 1]], faces, clockwise, uv=np.array([[0.0, 0], [1, 0], [0, 1]]),
                          texture=texture, colors=np.eye(3), background_color=np.zeros(3), height=40, width=60,
                          textured=np.ones(1, bool), shaded=np.ones(1, bool))
    image = port.render_scene(scene, 0.0)[0].numpy()
    np.testing.assert_allclose(image[0, :, :], 0, atol=1e-12)
    np.testing.assert_allclose(image[:, 0, :], 0, atol=1e-12)
    np.testing.assert_allclose(image[1, 1, :], [1, 0, 0], atol=1e-9)
    np.testing.assert_allclose(image[15, 1, :], [0, 1, 0], atol=1e-9)
    np.testing.assert_allclose(image[1, 15, :], [0, 0, 1], atol=1e-9)
