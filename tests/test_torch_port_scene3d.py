"""The port's ``Scene3D`` (deodr_tpu_torch.scene) against the JAX package's
on the CPU, meshes and cameras made from a seed with numpy and handed to
both:

- the planner ``_eager_plan`` field by field against
  ``Scene3D(impl="pallas")._eager_plan``: the duck with and without
  ``DEODR_QUAD_FETCH``, the textured torus of tests/torch_port_scenes.py
  (384 faces, a uv seam, split silhouette edges) and its untextured twin,
  then two views in turn (the plan hysteresis). On textured plans with
  split edges the port sizes ``edge_capacity`` from the segments, which is
  asserted to hold their count instead;
- ``render`` + ``render_backward`` in float64 against the JAX
  ``_eager_plan`` + ``_build_buffers`` + ``render_scene(impl="pallas",
  impl_interpret=True)`` and ``jax.vjp`` to vertices, light, uv and
  texture, on the textured torus (96×128, a 64² texture) at σ = 1 with the
  per-pixel fetch and at σ = 0 with the quad fetch (σ = 1 with the quad
  fetch from tests/test_torch_port_quad.py, so that each file keeps to its
  time budget): image and z within 1e-9,
  gradients within 1e-9 of their scale. The JAX plan's edge capacity is
  replaced by the port's (see ``_jax_scene3d_grads``);
- ``render_depth`` + ``render_depth_backward`` on the untextured torus at
  σ = 0 against the same JAX path (the untextured render, and depth at
  σ = 1, in tests/test_torch_port_scene3d_untextured.py);
- ``aa_window`` / ``aa_tex_window`` accepted and ignored on the tiled
  routes, and the "texture tile compaction" capacity check.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deodr_tpu
import deodr_tpu_torch as port
from deodr_tpu import ColoredTriMesh as JaxColoredTriMesh
from deodr_tpu.camera import Camera as JaxCamera
from deodr_tpu.camera import default_camera as jax_default_camera
from deodr_tpu.ops.render import render_scene as jax_render_scene
from deodr_tpu.scene import Scene3D as JaxScene3D
from deodr_tpu_torch import duck_scene
from deodr_tpu_torch.camera import Camera, default_camera
from deodr_tpu_torch.geometry.mesh import ColoredTriMesh
from deodr_tpu_torch.ops import tiled as port_tiled
from deodr_tpu_torch.ops.common import bilinear_sample_quads
from deodr_tpu_torch.scene import Scene3D
from torch_port_scenes import torus_arrays, torus_camera_arrays

DUCK = os.path.join(deodr_tpu.data_path, "duck.obj")
ROT = np.diag([1.0, -1.0, -1.0])
LIGHT = (np.array([-0.4, -0.4, -0.8]), 0.4)
BACKGROUND = np.array([0.2, 0.3, 0.5])
ALL_GRADS = ("vertices", "vertices_colors", "light_directional", "light_ambient", "uv", "texture")
GRADS = ("vertices", "light_directional", "light_ambient", "uv", "texture")


def _meshes(textured=True, **kwargs):
    a = torus_arrays(textured, **kwargs)
    kw = {k: v for k, v in a.items() if k not in ("faces", "vertices")}
    return (ColoredTriMesh(a["faces"], torch.from_numpy(a["vertices"]), **kw),
            JaxColoredTriMesh(a["faces"], a["vertices"], **kw))


def _cameras(view=0):
    args = torus_camera_arrays(view)
    return Camera(*args), JaxCamera(*args)


def _scenes(mesh_p, mesh_j, sigma, quad_fetch=False):
    scene_p = Scene3D(sigma=sigma, device="cpu", quad_fetch=quad_fetch)
    scene_j = JaxScene3D(sigma=sigma, impl="pallas")
    for s, m in ((scene_p, mesh_p), (scene_j, mesh_j)):
        s.set_mesh(m)
        s.set_light(*LIGHT)
        s.set_background_color(BACKGROUND)
    return scene_p, scene_j


def _assert_plans_equal(plan_p, plan_j, segments_counted=False):
    cap_p, tiling_p, win_p, texwin_p, texplan_p = plan_p
    cap_j, tiling_j, win_j, texwin_j, texplan_j = plan_j
    assert (cap_p, win_p, texwin_p) == (cap_j, win_j, texwin_j)
    assert (tiling_p is None) == (tiling_j is None) and (texplan_p is None) == (texplan_j is None)
    if tiling_p is not None:
        for name in tiling_p._fields:
            if name != "edge_capacity" or not segments_counted:
                assert getattr(tiling_p, name) == getattr(tiling_j, name), name
    if texplan_p is not None:
        for name in texplan_p._fields:
            assert getattr(texplan_p, name) == getattr(texplan_j, name), name


def _segment_count(scene_p, camera, plan):
    """Largest number of split-segment bands in one edge tile of ``plan``."""
    _, tiling, _, _, tex_plan = plan
    _, band_count = scene_p._plan_statistics(camera, True, True)
    return band_count(tiling.edge_tile_h or tiling.tile_h, tex_plan)


# ---------------------------------------------------------------- the planner


@pytest.mark.parametrize("quad", [False, True], ids=["per-pixel", "quad"])
def test_duck_plan_matches_jax_planner(monkeypatch, quad):
    if quad:
        monkeypatch.setenv("DEODR_QUAD_FETCH", "1")
    else:
        monkeypatch.delenv("DEODR_QUAD_FETCH", raising=False)
    mesh_p, mesh_j = ColoredTriMesh.load(DUCK), JaxColoredTriMesh.load(DUCK)
    scene_p, scene_j = _scenes(mesh_p, mesh_j, 1.0, quad_fetch=None)
    camera_p = default_camera(640, 480, 60, mesh_p.vertices.numpy(), ROT)
    camera_j = jax_default_camera(640, 480, 60, np.asarray(mesh_j.vertices), ROT)
    plan_p = scene_p._eager_plan(camera_p)
    _assert_plans_equal(plan_p, scene_j._eager_plan(camera_j), segments_counted=True)
    cap, tiling, _, _, tex_plan = plan_p
    # the duck's constants (duck_scene): the segment-sized edge capacity, and the
    # quad fetch's fallback capacity where it is turned on
    assert cap == duck_scene.DUCK_AA_EDGE_CAPACITY and tex_plan == duck_scene.DUCK_TEX_PLAN
    assert tiling == duck_scene.DUCK_TILING._replace(quad_fallback_capacity=1536 if quad else 0)
    assert tiling.edge_capacity >= _segment_count(scene_p, camera_p, plan_p) > 64


@pytest.mark.parametrize("textured", [True, False], ids=["textured", "untextured"])
def test_torus_plan_matches_jax_planner_over_two_views(textured):
    """Both views planned in turn on one scene of each package: the second
    keeps the first's capacities where they still fit (the hysteresis)."""
    mesh_p, mesh_j = _meshes(textured)
    scene_p, scene_j = _scenes(mesh_p, mesh_j, 1.0, quad_fetch=False)
    fresh_p, _ = _scenes(mesh_p, mesh_j, 1.0, quad_fetch=False)
    for view in (0, 1):
        camera_p, camera_j = _cameras(view)
        plan_p = scene_p._eager_plan(camera_p)
        _assert_plans_equal(plan_p, scene_j._eager_plan(camera_j), segments_counted=textured)
        if textured:
            assert plan_p[4].n_split > 1
            assert plan_p[1].edge_capacity >= _segment_count(scene_p, camera_p, plan_p) > plan_p[1].edge_capacity // 4
        if view == 1:
            alone = fresh_p._eager_plan(camera_p)
            kept = {name for name in plan_p[1]._fields if getattr(plan_p[1], name) != getattr(alone[1], name)}
            assert kept == ({"tex_tile_capacity"} if textured else set()), kept


# -------------------------------------------------------------- the render


def _jax_scene3d_grads(scene_j, camera_j, weight, edge_capacity=None, depth_scale=None):
    """The JAX Scene3D path: plan, buffers, render_scene on the Pallas
    kernels in interpret mode, and jax.vjp of Σ image · weight to every
    input the scene has → (image, z-buffer, gradients by name). The JAX
    plan's edge capacity counts whole edges, which drops segments where a
    plan splits them: ``edge_capacity`` (the port's) replaces it."""
    cap, tiling, aa_window, aa_tex_window, aa_tex_plan = scene_j._eager_plan(camera_j)
    if edge_capacity is not None:
        tiling = tiling._replace(edge_capacity=edge_capacity)
    inputs = scene_j._diff_inputs(depth_scale is not None)
    names = [n for n, x in zip(ALL_GRADS, inputs) if x is not None]

    def loss(*present):
        given = iter(present)
        args = [None if x is None else next(given) for x in inputs]
        buffers, _ = scene_j._build_buffers(camera_j, *args, True, depth_scale)
        image, z_buffer, _ = jax_render_scene(
            buffers, float(scene_j.sigma), aa_edge_capacity=cap, tiling=tiling, impl="pallas", impl_interpret=True,
            aa_window=aa_window, aa_tex_window=aa_tex_window, aa_tex_plan=aa_tex_plan,
        )
        return jnp.sum(image * weight), (image, z_buffer)

    present = [x for x in inputs if x is not None]
    (_, (image, z_buffer)), grads = jax.jit(jax.value_and_grad(loss, argnums=tuple(range(len(present))),
                                                               has_aux=True))(*present)
    return np.asarray(image), np.asarray(z_buffer), dict(zip(names, map(np.asarray, grads)))


def _port_scene3d_grads(scene_p, camera_p, weight, depth_scale=None):
    if depth_scale is None:
        image, z_buffer = scene_p.render(camera_p, return_z_buffer=True, check_capacity=True)
        scene_p.render_backward(torch.from_numpy(weight))
    else:
        image, z_buffer = scene_p.render_depth(camera_p, depth_scale=depth_scale, check_capacity=True), None
        scene_p.render_depth_backward(torch.from_numpy(weight))
    mesh = scene_p.mesh
    grads = dict(vertices=mesh._vertices_b, vertices_colors=mesh.vertices_colors_b,
                 light_directional=scene_p.light_directional_b, light_ambient=scene_p.light_ambient_b,
                 uv=getattr(mesh, "uv_b", None), texture=getattr(mesh, "texture_b", None))
    grads = {k: v.numpy() for k, v in grads.items() if v is not None}
    return image.numpy(), None if z_buffer is None else z_buffer.numpy(), grads


def check_scene3d_against_jax(scene_p, scene_j, camera_p, camera_j, depth_scale=None, edge_capacity=None,
                              min_covered=2000):
    """Render and back-propagate Σ image · weight through both packages:
    image and z within 1e-9, every gradient the JAX path gives within 1e-9
    of its scale; returns the port's gradients."""
    h, w = camera_p.height, camera_p.width
    c = 1 if depth_scale is not None else 3
    weight = np.cos(np.arange(h * w * c, dtype=np.float64)).reshape(h, w, c)
    img_j, zb_j, g_j = _jax_scene3d_grads(scene_j, camera_j, jnp.asarray(weight), edge_capacity, depth_scale)
    img_p, zb_p, g_p = _port_scene3d_grads(scene_p, camera_p, weight, depth_scale)
    assert img_p.shape == img_j.shape == (h, w, c)
    assert np.abs(img_p - img_j).max() <= 1e-9
    fin = np.isfinite(zb_j)
    assert fin.sum() > min_covered
    if zb_p is not None:
        np.testing.assert_array_equal(fin, np.isfinite(zb_p))
        assert np.abs(zb_p[fin] - zb_j[fin]).max() <= 1e-9
    assert set(g_p) == set(g_j)
    for k in g_j:
        scale = max(1.0, float(np.abs(g_j[k]).max()))
        assert g_p[k].shape == g_j[k].shape, k
        assert np.abs(g_p[k] - g_j[k]).max() <= 1e-9 * scale, k
    return g_p


def check_scene3d_render_and_backward(monkeypatch, sigma, quad):
    """The port's Scene3D render and backward on the textured torus against
    the JAX path (see the module docstring); with ``quad``, some quads must
    go through the per-pixel fallback."""
    if quad:
        monkeypatch.setenv("DEODR_QUAD_FETCH", "1")
    else:
        monkeypatch.delenv("DEODR_QUAD_FETCH", raising=False)
    # a 64² texture at about 4 texels per silhouette edge: unsplit edges keep the
    # interpret-mode JAX edge pass affordable (split plans: the planner tests here,
    # the renders of tests/test_torch_port_textured*.py)
    mesh_p, mesh_j = _meshes(tex_size=64, uv_step=(3.5, 4.5))
    scene_p, scene_j = _scenes(mesh_p, mesh_j, sigma, quad_fetch=quad)
    camera_p, camera_j = _cameras()
    plan = scene_p._eager_plan(camera_p)
    assert (plan[1].quad_fallback_capacity > 0) == quad and plan[1].tex_tile_capacity > 0
    fallbacks = []

    def counting(*args, **kwargs):  # records the fallback count that check_capacity reads
        out = bilinear_sample_quads(*args, **kwargs)
        fallbacks.append(args[4][-1][1])
        return out

    monkeypatch.setattr(port_tiled, "bilinear_sample_quads", counting)
    g_p = check_scene3d_against_jax(scene_p, scene_j, camera_p, camera_j, edge_capacity=plan[1].edge_capacity)
    for k in GRADS:
        assert np.abs(g_p[k]).max() > 0, k
    if quad:
        assert int(fallbacks[0]) > 0, "the uv seam sends no quad through the per-pixel fallback"


# σ = 1 with the quad fetch runs from tests/test_torch_port_quad.py, which keeps each file's time in bounds
@pytest.mark.parametrize("sigma,quad", [(1.0, False), (0.0, True)], ids=["sigma1-per-pixel", "sigma0-quad"])
def test_scene3d_render_and_backward_match_jax(monkeypatch, sigma, quad):
    check_scene3d_render_and_backward(monkeypatch, sigma, quad)


def test_scene3d_render_depth_backward():
    """render_depth (colors = depth × scale, one channel) and its backward
    against the JAX path at σ = 0 (σ = 1 in
    tests/test_torch_port_scene3d_untextured.py)."""
    mesh_p, mesh_j = _meshes(textured=False)
    scene_p, scene_j = _scenes(mesh_p, mesh_j, 0.0)
    for s in (scene_p, scene_j):
        s.background_color = np.array([5.0])
    g = check_scene3d_against_jax(scene_p, scene_j, *_cameras(), depth_scale=0.5)
    assert np.abs(g["vertices"]).max() > 0 and np.abs(g["vertices_colors"]).max() == 0


# -------------------------------------------------- windows and capacities


def test_aa_windows_are_ignored_on_the_tiled_routes():
    """The planner's aa_window / aa_tex_window serve the sequential edge
    pass; the tiled routes ignore them, as the JAX package's do."""
    from torch_port_scenes import AA_EDGE_CAPACITY, SIGMA, TILING, plan_scene

    fields, kw = plan_scene("split")
    scene = port.scene_buffers_from_numpy(fields, device="cpu")
    untextured = dataclasses.replace(scene, texture=None, textured=torch.zeros_like(scene.textured))
    for s, plan in ((scene, port.EdgeTexPlan(**kw)), (untextured, None)):
        args = dict(aa_edge_capacity=AA_EDGE_CAPACITY, tiling=port.TilingConfig(**TILING), aa_tex_plan=plan,
                    check_capacity=True)
        image, _, _ = port.render_scene(s, SIGMA, **args)
        windowed, _, _ = port.render_scene(s, SIGMA, aa_window=(32, 128), aa_tex_window=(16, 16), **args)
        assert torch.equal(image, windowed)


def test_texture_tile_compaction_overflow_raises():
    from torch_port_scenes import TILING, mixed_scene_fields

    scene = port.scene_buffers_from_numpy(mixed_scene_fields(), device="cpu")
    tiling = port.TilingConfig(**TILING)
    full, _, _ = port.render_scene(scene, 0.0, tiling=tiling, check_capacity=True)
    blocks, _, _ = port.render_scene(scene, 0.0, tiling=tiling._replace(tex_tile_capacity=96, tex_block_w=32),
                                     check_capacity=True)
    assert np.abs((blocks - full).numpy()).max() <= 1e-12
    with pytest.raises(RuntimeError, match="texture tile compaction overflow"):
        port.render_scene(scene, 0.0, tiling=tiling._replace(tex_tile_capacity=2), check_capacity=True)


def test_luminosity_tie_gradient_matches_jax():
    """max(0, x) at a tie: the apex normal of a square pyramid is exactly
    (0, 0, 1), perpendicular to the light (1, 0, 0), so x = 0 there; its
    gradient to the light is half of −n, as ``jnp.maximum`` gives (a
    ``clamp_min`` would give 0)."""
    vertices = np.array([[0.0, 0.0, 1.0], [1, 1, 0], [-1, 1, 0], [-1, -1, 0], [1, -1, 0]])
    faces = np.array([[0, 1, 2], [0, 2, 3], [0, 3, 4], [0, 4, 1], [1, 3, 2], [1, 4, 3]])
    light = np.array([1.0, 0.0, 0.0])
    mesh_p = ColoredTriMesh(faces, torch.from_numpy(vertices), colors=np.ones((5, 3)))
    mesh_j = JaxColoredTriMesh(faces, vertices, colors=np.ones((5, 3)))
    scene_p, scene_j = _scenes(mesh_p, mesh_j, 0.0)
    light_t = torch.from_numpy(light).requires_grad_(True)
    (g_p,) = torch.autograd.grad(scene_p._luminosity(mesh_p.vertices, light_t, 0.4)[0], light_t)
    g_j = jax.grad(lambda l: scene_j._luminosity(jnp.asarray(vertices), l, 0.4)[0])(jnp.asarray(light))
    np.testing.assert_array_equal(mesh_p.vertex_normals[0].numpy(), [0.0, 0.0, 1.0])
    np.testing.assert_array_equal(g_p.numpy(), np.asarray(g_j))
    np.testing.assert_array_equal(g_p.numpy(), [0.0, 0.0, -0.5])
