"""Repairs of the port and its public surface, on the CPU:

- B1b's batched launches: the plan of launches over batches of attribute
  planes and windows of slots (``raster_bwd_batches``), one launch where
  the table fits a block's shared memory, and the gradient table assembled
  from the batches (``raster_bwd_split``, each batch through the plain
  version) equal to the unsplit plain version, in float64;
- a second backward of one render: ``Scene2D`` adds the gradients again
  and ``Scene3D`` stores the new ones, against the JAX classes' two calls
  (1e-9 of scale);
- the JAX package's public names importable from ``deodr_tpu_torch``,
  ``Camera.xfov`` / ``yfov`` / ``world_to_camera`` /
  ``left_mul_intrinsic`` / ``__repr__`` and ``ColoredTriMesh.plot`` /
  ``plot_uv_map`` against JAX's;
- the degenerate-geometry contract of tests/test_degenerate_gradients.py
  through the port's plain versions: finite loss and gradients on the
  untiled, windowed and tiled routes at σ = 0 and 1, and the flags of
  ``safe_barycentric_matrices``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deodr_tpu
import deodr_tpu_torch
import torch_port_scenes  # noqa: F401  (one PyTorch thread a worker)
from deodr_tpu.camera import Camera as JaxCamera
from deodr_tpu.geometry.mesh import ColoredTriMesh as JaxColoredTriMesh
from deodr_tpu.scene import Scene2D as JaxScene2D
from deodr_tpu.scene import Scene3D as JaxScene3D
from deodr_tpu_torch import Camera, ColoredTriMesh, Scene2D, Scene3D, TilingConfig, render_scene
from deodr_tpu_torch.ops.common import safe_barycentric_matrices
from deodr_tpu_torch.ops.kernels import TileGrid
from deodr_tpu_torch.ops.kernels import raster_kernel as rk
from deodr_tpu_torch.ops.render import scene_buffers_from_numpy
from examples import triangle_soup_fitting as jax_soup
from test_degenerate_gradients import _degenerate_ij, _scene_f32
from torch_port_scenes import torus_arrays, torus_camera_arrays

LIMIT = 1e-9


def _close(a, b, limit=LIMIT):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    assert np.abs(a - b).max(initial=0.0) <= limit * max(1.0, np.abs(b).max(initial=0.0))


# ------------------------------------------------------------ B1b's batches


@pytest.mark.parametrize(
    "cap, d, itemsize, want",
    [
        (64, 3, 4, [(0, 3, 0, 64)]),
        (1024, 7, 4, [(0, 7, 0, 1024)]),
        (1024, 14, 8, [(0, 9, 0, 1024), (9, 14, 0, 1024)]),
        (16384, 1, 8, [(0, 1, 0, 9685), (0, 1, 9685, 16384)]),
        (20000, 2, 4, [(0, 1, 0, 19370), (1, 2, 0, 19370), (0, 2, 19370, 20000)]),
        (0, 3, 8, [(0, 3, 0, 0)]),
    ],
    ids=["fits", "fits-f32-d7", "planes-f64-d14", "slots-f64", "slots-and-planes-f32", "empty"],
)
def test_raster_bwd_batches(cap, d, itemsize, want):
    """The largest batches of planes whose (k1 − k0) × 3·b × itemsize fits
    232448 bytes; windows of slots (9685 in float64, 19370 in float32)
    where one plane at the full capacity does not. The batches cover every
    (plane, slot) once, each launch shape is accepted, and a single launch
    of a table that needs several is refused."""
    batches = rk.raster_bwd_batches(cap, d, itemsize)
    assert [tuple(b) for b in batches] == want
    cover = np.zeros((d, cap), int)
    for b in batches:
        cover[b.d0 : b.d1, b.k0 : b.k1] += 1
        rk.raster_bwd_launch_shape(16, 128, b.k1 - b.k0, b.d1 - b.d0, itemsize)
    assert (cover == 1).all()
    if len(batches) > 1:
        with pytest.raises(ValueError, match="shared memory"):
            rk.raster_bwd_launch_shape(16, 128, cap, d, itemsize)


def _bwd_inputs(grid, cap, d, seed):
    """A slot map with every slot and the miss value ``cap``, tile counts at,
    below and above the capacity, and float64 cotangents."""
    rng = np.random.RandomState(seed)
    hp, wp = grid.padded_hw
    slot_map = torch.from_numpy(rng.randint(0, cap + 1, (hp, wp)).astype(np.int32))
    counts = torch.from_numpy(rng.randint(0, cap + 8, grid.n_tiles).astype(np.int32))
    counts[0] = cap
    g_vals = torch.from_numpy(rng.randn(d, hp, wp))
    return slot_map, g_vals, counts


@pytest.mark.parametrize("case", ["planes-d14", "slots-16384", "slots-and-planes"])
def test_raster_bwd_split_matches_unsplit(case):
    """The table assembled from one plain-version call a batch equals the
    plain version's unsplit table exactly: D = 14 at capacity 1024 (the
    plan's two plane batches), D = 1 at 16384 (two slot windows), and
    windows of 7 slots with batches of 2 planes."""
    if case == "planes-d14":
        grid, cap, d = TileGrid(2, 2, 8, 16), 1024, 14
        batches = rk.raster_bwd_batches(cap, d, 8)
    elif case == "slots-16384":
        grid, cap, d = TileGrid(1, 2, 8, 16), 16384, 1
        batches = rk.raster_bwd_batches(cap, d, 8)
    else:
        grid, cap, d = TileGrid(2, 3, 8, 16), 40, 5
        batches = [rk.RasterBwdBatch(d0, min(d, d0 + 2), k0, min(cap, k0 + 7))
                   for k0 in range(0, cap, 7) for d0 in range(0, d, 2)]
    assert len(batches) > 1
    slot_map, g_vals, counts = _bwd_inputs(grid, cap, d, seed=len(case))
    want = rk.raster_bwd_reference(slot_map, g_vals, counts, grid, cap)
    got = rk.raster_bwd_split(slot_map, g_vals, counts, grid, cap, batches, rk.raster_bwd_reference)
    assert float(want.abs().max()) > 0
    assert torch.equal(got, want)


# ------------------------------------------------------- a second backward


def test_scene2d_second_backward_adds_again_as_jax():
    """Two render_backward calls after one render, then two
    render_error_backward calls after one render_error, on the triangle
    soup (30 triangles, untiled): each call adds its gradients, as JAX's."""
    np.random.seed(2)
    ref = jax_soup.create_example_scene(clockwise=True)
    names = ("faces", "faces_uv", "ij", "depths", "textured", "uv", "shade", "colors", "shaded", "edgeflags",
             "texture", "background_image", "background_color")
    kw = {name: getattr(ref, name) for name in names}
    kw.update(height=ref.height, width=ref.width, nb_colors=ref.nb_colors, clockwise=True, backface_culling=True)
    port, ref = Scene2D(**kw, device="cpu"), JaxScene2D(**kw)
    rng = np.random.RandomState(4)
    cots = [rng.rand(ref.height, ref.width, 3) for _ in range(2)]
    obs = rng.rand(ref.height, ref.width, 3)
    for scene in (port, ref):
        scene.clear_gradients()
    grads = ("ij_b", "colors_b", "uv_b", "shade_b", "texture_b")
    for mode in ("image", "error"):
        for scene in (port, ref):
            if mode == "image":
                scene.render(sigma=1)
            else:
                scene.render_error(obs, sigma=1)
        for k, cot in enumerate(cots):
            for scene in (port, ref):
                if mode == "image":
                    scene.render_backward(cot)
                else:
                    scene.render_error_backward(cot[:, :, 0])
            for name in grads:
                _close(getattr(port, name), getattr(ref, name))
            if k == 1:
                assert np.abs(port.ij_b).max() > 0


def test_scene3d_second_backward_stores_the_new_gradients_as_jax():
    """Two render_backward calls after one render of the untextured torus
    (192 faces, untiled, σ = 1), with different cotangents: each stores the
    gradients of its own, as JAX's; a backward before any render raises."""
    a = torus_arrays(textured=False, n=8, m=12)
    extrinsic, intrinsic, height, width = torus_camera_arrays()
    scenes = []
    for scene_cls, mesh_cls, camera_cls, kw in ((Scene3D, ColoredTriMesh, Camera, dict(device="cpu")),
                                                (JaxScene3D, JaxColoredTriMesh, JaxCamera, {})):
        vertices = torch.from_numpy(a["vertices"]) if scene_cls is Scene3D else a["vertices"]
        scene = scene_cls(sigma=1.0, **kw)
        scene.set_mesh(mesh_cls(a["faces"], vertices, colors=a["colors"]))
        scene.set_light(np.array([-0.4, -0.4, -0.8]), 0.4)
        scene.set_background_color(np.array([0.2, 0.3, 0.5]))
        scenes.append((scene, camera_cls(extrinsic, intrinsic, height, width)))
    with pytest.raises(RuntimeError, match="render"):
        scenes[0][0].render_backward(np.zeros((height, width, 3)))
    for scene, camera in scenes:
        scene.render(camera)
    rng = np.random.RandomState(5)
    for _ in range(2):
        cot = rng.rand(height, width, 3)
        got = []
        for scene, _ in scenes:
            scene.render_backward(cot)
            got.append([np.asarray(x) for x in (scene.mesh._vertices_b, scene.mesh.vertices_colors_b,
                                                scene.light_directional_b, scene.light_ambient_b)])
        for p, j in zip(*got):
            _close(p, j)
        assert np.abs(got[0][0]).max() > 0


# ------------------------------------------------------ the public surface


def test_public_names_match_jax():
    names = set(deodr_tpu.__all__) - {"__version__"}
    assert names <= set(deodr_tpu_torch.__all__)
    for name in names:
        assert hasattr(deodr_tpu_torch, name), name
        assert type(getattr(deodr_tpu_torch, name)) is type(getattr(deodr_tpu, name)), name


def test_camera_methods_match_jax():
    extrinsic, intrinsic, height, width = torus_camera_arrays()
    port = Camera(extrinsic, intrinsic, height, width, distortion=[0.1, -0.02, 0.001, 0.002, 0.0])
    ref = JaxCamera(extrinsic, intrinsic, height, width, distortion=[0.1, -0.02, 0.001, 0.002, 0.0])
    points = np.random.RandomState(6).randn(50, 3) + [0, 0, 5]
    _close(port.world_to_camera(torch.from_numpy(points)).numpy(), ref.world_to_camera(jnp.asarray(points)), 1e-12)
    projected = points[:, :2] / points[:, 2:]
    _close(port.left_mul_intrinsic(torch.from_numpy(projected)).numpy(),
           ref.left_mul_intrinsic(jnp.asarray(projected)), 1e-12)
    assert repr(port) == repr(ref)
    # the field of view needs the principal point at the centre (torus_camera_arrays moves it off)
    for name in ("xfov", "yfov"):
        with pytest.raises(ValueError, match=name):
            getattr(port, name)
    centred = intrinsic.copy()
    centred[:2, 2] = width / 2, height / 2
    port, ref = Camera(extrinsic, centred, height, width), JaxCamera(extrinsic, centred, height, width)
    assert (port.xfov, port.yfov) == (ref.xfov, ref.yfov)
    persp = deodr_tpu_torch.PerspectiveCamera(64, 48, 50.0, np.array([0.1, 0.2, -3.0]))
    assert abs(persp.xfov - 50.0) < 1e-12


def test_mesh_plot_helpers_match_jax(tmp_path):
    """tests/test_viewer.py::test_mesh_plot_helpers on both packages (Agg
    backend): the same surface and arrows, the same UV triangulation over
    the same texture."""
    matplotlib = pytest.importorskip("matplotlib")
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from deodr_tpu.geometry.primitives import octahedron_mesh as jax_octahedron_mesh
    from deodr_tpu_torch.geometry.primitives import octahedron_mesh

    arrows = []
    for mesh in (octahedron_mesh(2), jax_octahedron_mesh(2)):
        fig = plt.figure()
        ax = fig.add_subplot(projection="3d")
        mesh.plot(ax)
        fig.savefig(tmp_path / "mesh.png")
        arrows.append(np.concatenate([np.asarray(seg).reshape(-1) for seg in ax.collections[-1]._segments3d]))
        plt.close(fig)
    _close(arrows[0], arrows[1], 1e-12)

    tex = np.linspace(0, 1, 4 * 4 * 3).reshape(4, 4, 3)
    kw = dict(faces=np.array([[0, 1, 2]], dtype=np.int32), vertices=np.array([[0.0, 0, 0], [1, 0, 0], [0, 1, 0]]),
              faces_uv=np.array([[0, 1, 2]], dtype=np.int32), uv=np.array([[0.0, 0], [3, 0], [0, 3]]), texture=tex,
              compute_adjacencies=False)
    drawn = []
    for mesh in (ColoredTriMesh(**kw), JaxColoredTriMesh(**kw)):
        fig, ax = plt.subplots()
        mesh.plot_uv_map(ax)
        fig.savefig(tmp_path / "uv.png")
        drawn.append((np.asarray(ax.images[0].get_array()), np.concatenate([ln.get_xydata() for ln in ax.lines])))
        plt.close(fig)
    for a, b in zip(*drawn):
        np.testing.assert_array_equal(a, b)
    no_uv = ColoredTriMesh(faces=kw["faces"], vertices=kw["vertices"], colors=np.ones((3, 3)),
                           compute_adjacencies=False)
    with pytest.raises(ValueError, match="uv"):
        no_uv.plot_uv_map(None)


# ------------------------------------------------------ degenerate geometry


def test_safe_barycentric_flags():
    ij = torch.from_numpy(_degenerate_ij()).reshape(4, 3, 2)
    inv, valid = safe_barycentric_matrices(ij)
    assert valid.tolist() == [True, False, False, False]
    assert bool(torch.isfinite(inv).all())
    v = torch.cat([ij[0], torch.ones((3, 1))], dim=1)
    assert float((v @ inv[0].T - torch.eye(3)).abs().max()) < 1e-4


@pytest.mark.parametrize("sigma", [0.0, 1.0])
@pytest.mark.parametrize("route", ["untiled", "windowed", "tiled"])
def test_degenerate_triangles_finite_gradients(route, sigma):
    """A healthy triangle, an exactly collinear one, a sliver below float32
    noise and a point, in float32 (every edge flagged at σ = 1): finite loss
    and gradients, and the healthy triangle still gets gradients."""
    n_tri = 4
    base = _scene_f32(_degenerate_ij(), n_tri, edgeflags=np.ones((n_tri, 3), bool) if sigma > 0 else None)
    fields = {f.name: getattr(base, f.name) for f in dataclasses.fields(base)}
    fields = {k: np.asarray(v) if hasattr(v, "shape") else v for k, v in fields.items()}
    scene = scene_buffers_from_numpy(fields, device="cpu", dtype=torch.float32)
    kw = dict(tiling=TilingConfig(16, 128, 16, 8)) if route == "tiled" else {}
    if route == "windowed":
        kw = dict(aa_window=(48, 96))
    ij = scene.ij.clone().requires_grad_(True)
    img, _, _ = render_scene(dataclasses.replace(scene, ij=ij), sigma, **kw)
    loss = (img**2).sum()
    (g,) = torch.autograd.grad(loss, (ij,))
    assert bool(torch.isfinite(loss)) and bool(torch.isfinite(g).all())
    assert float(g.abs().max()) > 0
