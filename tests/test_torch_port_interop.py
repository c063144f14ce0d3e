"""The port's torch class surface (``deodr_tpu_torch.interop``), its
``trimesh`` conversions and its ``run_ranks`` default against the JAX
package on the CPU. Inputs are made from a numpy seed, in float64, with the
vertices moved off the pixel lattice:

- ``Scene3DTorch`` forward and gradients (vertices, vertex colours,
  directional and ambient light) against JAX's ``Scene3DTorch`` on
  ``octahedron_mesh(2)`` at 64×48, σ = 0 and 1 (both untiled), within 1e-9
  of scale; the textured case of tests/test_torch_scene.py
  (``octahedron_mesh(1)``, uv and texture gradients) within 1e-9; a
  degenerate face (zero normal, no NaN) within 1e-9; a clockwise mesh,
  whose normals both ignore the flag, within 1e-9;
- ``octahedron_mesh(3)`` (512 faces: the port's tiled route) against JAX's
  untiled ``Scene3DTorch``, image and gradients within 1e-9 (the two
  band-clip forms, rational refinement untiled and thresholded planes
  tiled, could take different sides of a band's end at a pixel; no pixel
  of this view does), and the image against JAX's ``render_scene`` with
  the same tiling and ``impl="xla"``, within 1e-9;
- ``CameraTorch.project_points`` with distortion against JAX's, within
  1e-12, and its dtype and device rule;
- ``render_scene_torch`` against JAX's bridge on the same buffers, within
  1e-9, and above 256 faces against ``render_scene`` on ``plan_tiling``'s
  plan (one function: bit-equal);
- ``ColoredTriMesh.from_trimesh`` of both packages on stand-ins with
  trimesh's attributes, ``to_trimesh`` and ``load`` raising what JAX's
  raise on this host, ``load`` of data/duck.obj equal in both;
- ``import deodr_tpu_torch.interop`` with ``jax``, ``trimesh`` and
  ``matplotlib`` refused;
- ``run_ranks`` without ``device`` asking for the card and raising, before
  any rank is spawned, where there is none.
"""

import dataclasses
import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deodr_tpu
from deodr_tpu import ColoredTriMesh as JaxColoredTriMesh
from deodr_tpu.camera import default_camera
from deodr_tpu.geometry.primitives import octahedron_mesh as jax_octahedron_mesh
from deodr_tpu.interop import CameraTorch as JaxCameraTorch
from deodr_tpu.interop import Scene3DTorch as JaxScene3DTorch
from deodr_tpu.interop import render_scene_torch as jax_render_scene_torch
from deodr_tpu.ops.render import SceneBuffers as JaxSceneBuffers
from deodr_tpu.ops.render import render_scene as jax_render_scene
from deodr_tpu.ops.tiled import TilingConfig as JaxTiling
from deodr_tpu_torch.geometry.mesh import ColoredTriMesh
from deodr_tpu_torch.interop import CameraTorch, Scene3DTorch, render_scene_torch
from deodr_tpu_torch.ops.render import render_scene, scene_buffers_from_numpy
from deodr_tpu_torch.scene import PlanView, plan_tiling

ROT = np.array([[1.0, 0, 0], [0, -1, 0], [0, 0, -1]])
BACKGROUND = np.array([0.1, 0.2, 0.3])
LIGHT_DIRECTIONAL, LIGHT_AMBIENT = np.array([-0.5, 0.5, -0.5]), 0.4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _meshes(level, textured=False, seed=3, clockwise=False):
    """(port mesh, JAX mesh) of ``octahedron_mesh(level)``; textured: a
    seeded uv atlas and 8×8 texture, as tests/test_torch_scene.py builds;
    clockwise: its faces reversed and flagged so."""
    m = jax_octahedron_mesh(level)
    faces, vertices = np.asarray(m.faces), np.asarray(m.vertices)
    if clockwise:
        faces = np.ascontiguousarray(faces[:, ::-1])
    if textured:
        rng = np.random.RandomState(seed)
        kw = dict(uv=rng.rand(len(vertices), 2) * 6 + 1, texture=rng.rand(8, 8, 3), faces_uv=faces)
    else:
        kw = dict(colors=np.asarray(m.vertices_colors))
    kw["clockwise"] = clockwise
    return ColoredTriMesh(faces, vertices, **kw), JaxColoredTriMesh(faces, vertices, **kw)


def _inputs(mesh_j, textured=False, seed=0):
    """The render's differentiable inputs (numpy): the mesh's vertices moved
    off the pixel lattice, its colours or uv and texture, the lights."""
    rng = np.random.RandomState(seed)
    vertices = np.asarray(mesh_j.vertices)
    inputs = dict(vertices=vertices + rng.normal(scale=1e-3, size=vertices.shape),
                  light_directional=LIGHT_DIRECTIONAL, light_ambient=np.array(LIGHT_AMBIENT))
    if textured:
        inputs.update(uv=np.asarray(mesh_j.uv), texture=np.asarray(mesh_j.texture))
    else:
        inputs["vertices_colors"] = np.asarray(mesh_j.vertices_colors)
    return inputs


def _render(scene, camera, inputs, weight):
    """Σ image · weight back-propagated through ``scene.render`` → (image,
    gradients by input name)."""
    scene.set_background_color(BACKGROUND)
    leaves = {k: torch.tensor(v, requires_grad=True) for k, v in inputs.items()}
    image = scene.render(camera, **leaves)
    (image * torch.from_numpy(weight)).sum().backward()
    return image.detach().numpy(), {k: t.grad.numpy() for k, t in leaves.items()}


def _both(level, sigma, width, height, textured=False, edit=None, clockwise=False):
    """The port's and JAX's Scene3DTorch on the same mesh, camera and inputs
    → ((image, gradients) of the port, of JAX, the port's scene, camera)."""
    mesh_p, mesh_j = _meshes(level, textured, clockwise=clockwise)
    camera = default_camera(width, height, 60, np.asarray(mesh_j.vertices), ROT)
    inputs = _inputs(mesh_j, textured)
    if edit is not None:
        edit(inputs, np.asarray(mesh_j.faces))
    weight = np.cos(np.arange(height * width * 3, dtype=np.float64)).reshape(height, width, 3)
    scene_p = Scene3DTorch(sigma=sigma, device="cpu")
    scene_p.set_mesh(mesh_p)
    scene_j = JaxScene3DTorch(sigma=sigma)
    scene_j.set_mesh(mesh_j)
    camera_p = CameraTorch.from_camera(camera)
    port = _render(scene_p, camera_p, inputs, weight)
    ref = _render(scene_j, JaxCameraTorch.from_camera(camera), inputs, weight)
    return port, ref, scene_p, camera_p, inputs


def _assert_close(port, ref, tol=1e-9):
    (img_p, g_p), (img_j, g_j) = port, ref
    assert img_p.shape == img_j.shape and np.isfinite(img_p).all()
    assert np.abs(img_p - img_j).max() <= tol
    for k in g_j:
        assert np.isfinite(g_p[k]).all(), k
        assert np.abs(g_p[k] - g_j[k]).max() <= tol * max(1.0, float(np.abs(g_j[k]).max())), k


# ------------------------------------------------------------ Scene3DTorch


@pytest.mark.parametrize("sigma", [0.0, 1.0])
def test_scene3d_torch_matches_jax(sigma):
    port, ref, scene_p, camera, inputs = _both(2, sigma, 64, 48)
    _assert_close(port, ref)
    grads = port[1]
    assert set(grads) == {"vertices", "vertices_colors", "light_directional", "light_ambient"}
    assert all(np.abs(g).max() > 0 for g in grads.values())
    leaves = {k: torch.tensor(v) for k, v in inputs.items()}
    assert scene_p._scene._eager_plan(camera, True, _view(camera, leaves))[1] is None  # 128 faces: untiled


def test_scene3d_torch_textured_matches_jax():
    port, ref, _, _, _ = _both(1, 1.0, 48, 40, textured=True)
    _assert_close(port, ref)
    assert np.abs(port[1]["uv"]).max() > 0 and np.abs(port[1]["texture"]).max() > 0


def test_scene3d_torch_degenerate_face_matches_jax():
    """A face collapsed to a segment: its normal is zero, as in JAX's
    Scene3DTorch (and in the port's Scene3D; JAX's Scene3D gives NaN)."""

    def collapse(inputs, faces):
        f = faces[5]
        inputs["vertices"][f[1]] = inputs["vertices"][f[0]]

    port, ref, _, _, _ = _both(2, 1.0, 64, 48, edit=collapse)
    _assert_close(port, ref)


def test_scene3d_torch_clockwise_mesh_matches_jax():
    """The octahedron with its faces reversed and flagged clockwise: JAX's
    Scene3DTorch computes its normals without the flag, so the mesh is lit
    as from the opposite light, and the port does the same (unlike both
    packages' Scene3D)."""
    port, ref, _, _, _ = _both(2, 1.0, 64, 48, clockwise=True)
    _assert_close(port, ref)
    counter_clockwise, _, _, _, _ = _both(2, 1.0, 64, 48)
    assert np.abs(port[0] - counter_clockwise[0]).max() > 0.1


def test_scene3d_torch_tiled_route_matches_jax():
    """512 faces: the port plans the tiled route; against JAX's untiled
    Scene3DTorch and against JAX's render_scene with the same tiling and
    impl="xla"."""
    port, ref, scene_p, cam, inputs = _both(3, 1.0, 64, 48)
    _assert_close(port, ref)
    img_p = port[0]

    leaves = {k: torch.tensor(v) for k, v in inputs.items()}
    plan = scene_p._scene._eager_plan(cam, True, _view(cam, leaves))
    cap, tiling = plan[0], plan[1]
    assert tiling is not None and plan[4] is None
    buffers, _ = scene_p._scene._build_buffers(cam, leaves["vertices"], leaves["vertices_colors"],
                                               leaves["light_directional"], leaves["light_ambient"], None, None, True)
    fields = {f: getattr(buffers, f) for f in JaxSceneBuffers.__dataclass_fields__}
    jax_buffers = JaxSceneBuffers(**{k: jnp.asarray(v.numpy()) if torch.is_tensor(v) else v for k, v in fields.items()})
    # JAX's XLA tiled pass has no drawn-triangle compaction (a capacity, which changes no pixel)
    jax_tiling = JaxTiling(**tiling._replace(drawn_capacity=0)._asdict())
    img_x, _, _ = jax.jit(lambda b: jax_render_scene(b, 1.0, aa_edge_capacity=cap, tiling=jax_tiling,
                                                     impl="xla"))(jax_buffers)
    assert np.abs(img_p - np.asarray(img_x)).max() <= 1e-9


def _view(camera, leaves):
    ij, depths = camera.project_points(leaves["vertices"])
    return PlanView(ij, depths, None, None)


def test_scene3d_torch_checks(monkeypatch):
    mesh_p, _ = _meshes(1)
    scene = Scene3DTorch(sigma=1.0, device="cpu")
    camera = CameraTorch.from_camera(default_camera(32, 24, 60, mesh_p.vertices.numpy(), ROT))
    with pytest.raises(AssertionError, match="set_mesh"):
        scene.render(camera, mesh_p.vertices, vertices_colors=mesh_p.vertices_colors)
    scene.set_mesh(mesh_p)
    with pytest.raises(AssertionError, match="set_background_color"):
        scene.render(camera, mesh_p.vertices, vertices_colors=mesh_p.vertices_colors)
    scene.set_background_color(BACKGROUND)
    with pytest.raises(ValueError, match="vertices_colors is on meta"):
        scene.render(camera, mesh_p.vertices, vertices_colors=mesh_p.vertices_colors.to("meta"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Scene3DTorch()  # the card by default


# -------------------------------------------------------------- CameraTorch


def test_camera_torch_project_points_matches_jax():
    rng = np.random.RandomState(1)
    extrinsic = np.column_stack((ROT, [0.1, -0.2, 3.0]))
    intrinsic = np.array([[80.0, 0, 32.5], [0, 75.0, 24.25], [0, 0, 1]])
    distortion = np.array([-0.2, 0.05, 0.01, -0.02, 0.003])
    points = rng.uniform(-1, 1, (50, 3))
    cam_p = CameraTorch(extrinsic, intrinsic, 48, 64, distortion)
    cam_j = JaxCameraTorch(extrinsic, intrinsic, 48, 64, distortion)
    pts_p = torch.tensor(points, requires_grad=True)
    pts_j = torch.tensor(points, requires_grad=True)
    (ij_p, d_p), (ij_j, d_j) = cam_p.project_points(pts_p), cam_j.project_points(pts_j)
    assert np.abs(ij_p.detach().numpy() - ij_j.detach().numpy()).max() <= 1e-12
    assert np.abs(d_p.detach().numpy() - d_j.detach().numpy()).max() <= 1e-12
    (ij_p.sum() + d_p.sum()).backward()
    (ij_j.sum() + d_j.sum()).backward()
    assert np.abs(pts_p.grad.numpy() - pts_j.grad.numpy()).max() <= 1e-12
    assert cam_p.extrinsic.dtype == cam_p.intrinsic.dtype == cam_p.distortion.dtype == torch.float64
    ij32, d32 = cam_p.project_points(torch.tensor(points, dtype=torch.float32))
    assert ij32.dtype == d32.dtype == torch.float32


# ----------------------------------------------------------- render_scene_torch


def _soup_fields(n_tri, size, seed, textured=True):
    """A triangle soup's scene buffers (numpy, float64): seeded triangles,
    colours, a 4×4 texture on every other triangle where ``textured``,
    every edge flagged."""
    rng = np.random.RandomState(seed)
    nv = 3 * n_tri
    centers = rng.uniform(0, size, (n_tri, 1, 2))
    ij = (centers + rng.uniform(-0.1 * size, 0.1 * size, (n_tri, 3, 2))).reshape(nv, 2)
    faces = np.arange(nv).reshape(n_tri, 3)
    textured = (np.arange(n_tri) % 2 == 0) & textured
    return dict(faces=faces, faces_uv=faces, ij=ij, depths=rng.uniform(1, 2, nv), uv=rng.uniform(0.5, 2.5, (nv, 2)),
                shade=rng.uniform(0.3, 1, nv), colors=rng.uniform(0, 1, (nv, 3)),
                edgeflags=np.ones((n_tri, 3), bool), textured=textured, shaded=textured,
                texture=rng.uniform(0, 1, (4, 4, 3)), background_image=None, background_color=BACKGROUND,
                height=size, width=size, clockwise=False, backface_culling=False, strict_edge=True,
                perspective_correct=False, integer_pixel_centers=True)


DIFF = ("ij", "colors", "uv", "shade", "texture")


def _bridge_grads(render, buffers, fields, weight):
    leaves = [torch.tensor(fields[k], requires_grad=True) for k in DIFF]
    image = render(buffers, 1.0, *leaves)
    (image * torch.from_numpy(weight)).sum().backward()
    return image.detach().numpy(), [t.grad.numpy() for t in leaves]


def test_render_scene_torch_matches_jax_bridge():
    fields = _soup_fields(6, 48, seed=11)
    weight = np.sin(np.arange(48 * 48 * 3, dtype=np.float64)).reshape(48, 48, 3)
    jax_buffers = JaxSceneBuffers(**{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in fields.items()})
    port = _bridge_grads(lambda b, s, *t: render_scene_torch(b, s, *t, aa_edge_capacity=18),
                         scene_buffers_from_numpy(fields, device="cpu"), fields, weight)
    ref = _bridge_grads(lambda b, s, *t: jax_render_scene_torch(b, s, *t, aa_edge_capacity=18),
                        jax_buffers, fields, weight)
    assert np.abs(port[0] - ref[0]).max() <= 1e-9
    for g_p, g_j in zip(port[1], ref[1]):
        assert np.abs(g_p - g_j).max() <= 1e-9 * max(1.0, float(np.abs(g_j).max()))
    assert all(np.abs(g).max() > 0 for g in port[1])


def test_render_scene_torch_tiled_is_render_scene():
    """Above 256 faces the bridge takes plan_tiling's plan: the same image
    and gradients as render_scene on that plan, bit for bit."""
    fields = _soup_fields(300, 96, seed=2, textured=False)
    buffers = scene_buffers_from_numpy(fields, device="cpu")
    weight = np.cos(np.arange(96 * 96 * 3, dtype=np.float64)).reshape(96, 96, 3)
    tiling = plan_tiling(fields["ij"], fields["faces"], fields["edgeflags"], 96, 96, 1.0)
    assert tiling is not None

    def direct(b, s, *t):
        return render_scene(dataclasses.replace(b, **dict(zip(DIFF, t))), s, aa_edge_capacity=900, tiling=tiling)[0]

    port = _bridge_grads(lambda b, s, *t: render_scene_torch(b, s, *t, aa_edge_capacity=900), buffers, fields, weight)
    want = _bridge_grads(direct, buffers, fields, weight)
    assert np.array_equal(port[0], want[0]) and all(np.array_equal(a, b) for a, b in zip(port[1], want[1]))


# -------------------------------------------------------- trimesh conversions


def _stand_in(kind, vertices, faces, **visual):
    return SimpleNamespace(vertices=vertices, faces=faces, visual=SimpleNamespace(kind=kind, **visual))


def _split_cube():
    """A cube's 12 faces over 24 vertices: each corner three times, as a UV
    seam splits it."""
    corners = np.array([[x, y, z] for x in (0.0, 1.0) for y in (0.0, 1.0) for z in (0.0, 1.0)])
    quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1), (2, 3, 7, 6), (0, 2, 6, 4), (1, 5, 7, 3)]
    vertices, faces = [], []
    for q in quads:
        base = len(vertices)
        vertices.extend(corners[list(q)])
        faces.extend([[base, base + 1, base + 2], [base, base + 2, base + 3]])
    return np.array(vertices), np.array(faces)


def _assert_meshes_equal(mesh_p, mesh_j):
    np.testing.assert_array_equal(mesh_p.faces, np.asarray(mesh_j.faces))
    np.testing.assert_array_equal(mesh_p.vertices.numpy(), np.asarray(mesh_j.vertices))
    for name in ("uv", "texture", "vertices_colors"):
        a, b = getattr(mesh_p, name), getattr(mesh_j, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert (mesh_p.faces_uv is None) == (mesh_j.faces_uv is None)
    if mesh_p.faces_uv is not None:
        np.testing.assert_array_equal(mesh_p.faces_uv, np.asarray(mesh_j.faces_uv))
    assert mesh_p.clockwise == mesh_j.clockwise and mesh_p.nb_colors == mesh_j.nb_colors


def test_from_trimesh_matches_jax():
    rng = np.random.RandomState(4)
    vertices, faces = _split_cube()
    corner_colors = rng.randint(0, 256, (8, 4))
    corner = (vertices @ np.array([4, 2, 1])).astype(int)
    vertex = _stand_in("vertex", vertices, faces, vertex_colors=corner_colors[corner].astype(np.uint8))
    image = rng.randint(0, 256, (6, 10, 4)).astype(np.uint8)
    texture = _stand_in("texture", vertices, faces, uv=rng.rand(len(vertices), 2),
                        material=SimpleNamespace(image=image))
    for stand_in in (vertex, texture):
        mesh_p = ColoredTriMesh.from_trimesh(stand_in)
        _assert_meshes_equal(mesh_p, JaxColoredTriMesh.from_trimesh(stand_in))
        assert mesh_p.nb_vertices == 8 and mesh_p.adjacencies.is_closed
    assert ColoredTriMesh.from_trimesh(texture).texture.shape == (6, 10, 3)

    conflict = corner_colors[corner].astype(np.uint8)
    conflict[0, 0] ^= 1
    for bad, match in ((_stand_in("face", vertices, faces), "per-face"),
                       (_stand_in("vertex", vertices, faces, vertex_colors=conflict), "same color")):
        for cls in (ColoredTriMesh, JaxColoredTriMesh):
            with pytest.raises(ValueError, match=match):
                cls.from_trimesh(bad)


def _outcome(fn):
    try:
        return type(fn())
    except Exception as e:  # the exception's type is the outcome compared
        return type(e)


def test_to_trimesh_and_load_raise_as_jax(tmp_path):
    """On a host without trimesh, to_trimesh raises ModuleNotFoundError also
    for a vertex-coloured mesh (the imports come first) and load of a .ply
    file the ImportError; with trimesh, both packages give the same types."""
    textured_p, textured_j = _meshes(1, textured=True)
    colored_p, colored_j = _meshes(1)
    for mesh_p, mesh_j in ((textured_p, textured_j), (colored_p, colored_j)):
        assert _outcome(mesh_p.to_trimesh).__name__ == _outcome(mesh_j.to_trimesh).__name__
    ply = str(tmp_path / "mesh.ply")
    assert _outcome(lambda: ColoredTriMesh.load(ply)) is _outcome(lambda: JaxColoredTriMesh.load(ply))
    try:
        import trimesh  # noqa: F401
    except ImportError:
        assert _outcome(colored_p.to_trimesh) is ModuleNotFoundError
        assert issubclass(_outcome(lambda: ColoredTriMesh.load(ply)), ImportError)


def test_load_duck_matches_jax():
    duck = os.path.join(deodr_tpu.data_path, "duck.obj")
    _assert_meshes_equal(ColoredTriMesh.load(duck), JaxColoredTriMesh.load(duck))


# -------------------------------------------------------------- the imports


BLOCKER = """
import sys


class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "trimesh", "matplotlib", "deodr_tpu"):
            raise ModuleNotFoundError(f"No module named {name!r} (refused)")
        return None


sys.meta_path.insert(0, Refuse())
import deodr_tpu_torch
import deodr_tpu_torch.interop
from deodr_tpu_torch.interop import CameraTorch, Scene3DTorch, render_scene_torch
assert not any(m.split(".")[0] in ("jax", "trimesh", "matplotlib", "deodr_tpu") for m in sys.modules)
print("imported")
"""


def test_interop_imports_without_jax_trimesh_or_matplotlib():
    out = subprocess.run([sys.executable, "-c", BLOCKER], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "imported"


# ------------------------------------------------------------------ run_ranks


def _never_called(*args, **kwargs):
    raise AssertionError("a rank was spawned")


def test_run_ranks_defaults_to_the_card(monkeypatch):
    """No device: run_ranks asks for CUDA and, where there is none, raises
    before it builds a kernel or spawns a rank."""
    import torch.multiprocessing as mp

    from deodr_tpu_torch.ops import kernels
    from deodr_tpu_torch.parallel import run_ranks

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(mp, "spawn", _never_called)
    monkeypatch.setattr(kernels, "build", _never_called)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_ranks(_never_called, 2, ())
