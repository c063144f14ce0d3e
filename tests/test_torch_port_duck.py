"""What builds the duck scene in the port (deodr_tpu_torch: PNG and OBJ
readers, camera, mesh adjacency and normals, ``duck_scene``) against the JAX
package: ``ColoredTriMesh.load``, ``default_camera``,
``Scene3D._build_buffers`` and the planner ``Scene3D._eager_plan``. Integer
and boolean arrays must be equal, float64 results agree to 1e-12, and the
float32 scene fields to 1e-6 of their scale. The duck is not rendered at
full size here: that is the card's work (chip_smoke.py).
"""

import dataclasses
import os
import struct
import zlib

import numpy as np
import pytest
import torch

import deodr_tpu
from deodr_tpu import ColoredTriMesh as JaxColoredTriMesh
from deodr_tpu.camera import default_camera as jax_default_camera
from deodr_tpu.scene import Scene3D
from deodr_tpu_torch import duck_scene
from deodr_tpu_torch.camera import default_camera
from deodr_tpu_torch.geometry.mesh import ColoredTriMesh
from deodr_tpu_torch.io.obj import read_obj, save_obj
from deodr_tpu_torch.io.png import read_png
from deodr_tpu_torch.ops.render import scene_buffers_from_numpy

DUCK = os.path.join(deodr_tpu.data_path, "duck.obj")
ROT = np.array([[1.0, 0, 0], [0, -1, 0], [0, 0, -1]])


@pytest.fixture(scope="module")
def meshes():
    return ColoredTriMesh.load(DUCK), JaxColoredTriMesh.load(DUCK)


@pytest.fixture(scope="module")
def jax_duck(meshes):
    """The JAX package's duck: scene, camera and buffers as bench.measure_duck builds them."""
    _, mesh = meshes
    camera = jax_default_camera(640, 480, 60, np.asarray(mesh.vertices), ROT)
    scene = Scene3D(sigma=1.0, impl="pallas")
    scene.set_mesh(mesh)
    scene.set_light(np.array([-0.4, -0.4, -0.8]), 0.4)
    scene.set_background_color(np.array([0.2, 0.3, 0.5]))
    buffers, _ = scene._build_buffers(camera, *scene._diff_inputs(False), True, None)
    return scene, camera, buffers


# ------------------------------------------------------------------- readers


def _write_png(path, image, colour_type, filters, depth=8, interlace=0):
    """A PNG whose scanline y is filtered with type filters[y % len(filters)]."""
    h, w = image.shape[:2]
    bpp = 1 if image.ndim == 2 else image.shape[2]
    rows = image.reshape(h, w * bpp).astype(np.int64)
    raw = bytearray()
    for y in range(h):
        kind = filters[y % len(filters)]
        cur = rows[y]
        up = rows[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), up[:-bpp]])
        if kind == 0:
            pred = np.zeros_like(cur)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = up
        elif kind == 3:
            pred = (left + up) // 2
        else:
            p = left + up - upleft
            pa, pb, pc = abs(p - left), abs(p - up), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
        raw.append(kind)
        raw += bytes(((cur - pred) % 256).astype(np.uint8))

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    packed = zlib.compress(bytes(raw))
    half = len(packed) // 2
    with open(path, "wb") as fid:
        fid.write(b"\x89PNG\r\n\x1a\n")
        fid.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour_type, 0, 0, interlace)))
        fid.write(chunk(b"IDAT", packed[:half]) + chunk(b"IDAT", packed[half:]))
        fid.write(chunk(b"IEND", b""))


@pytest.mark.parametrize("shape,colour_type", [((9, 7, 3), 2), ((6, 5, 4), 6), ((8, 11), 0)],
                         ids=["rgb", "rgba", "grey"])
def test_read_png_undoes_every_filter(tmp_path, shape, colour_type):
    image = np.random.RandomState(0).randint(0, 256, shape).astype(np.uint8)
    path = tmp_path / "t.png"
    _write_png(path, image, colour_type, filters=[4, 3, 1, 2, 0, 4, 4, 3])
    out = read_png(path)
    assert out.dtype == np.uint8
    np.testing.assert_array_equal(out, image)


def test_read_png_refuses_what_it_does_not_read(tmp_path):
    image = np.zeros((4, 4, 3), np.uint8)
    _write_png(tmp_path / "i.png", image, 2, [0], interlace=1)
    with pytest.raises(ValueError, match="interlac"):
        read_png(tmp_path / "i.png")
    _write_png(tmp_path / "d.png", image, 2, [0], depth=16)
    with pytest.raises(ValueError, match="bit depth 16"):
        read_png(tmp_path / "d.png")
    (tmp_path / "n.png").write_bytes(b"not a png at all")
    with pytest.raises(ValueError, match="not a PNG"):
        read_png(tmp_path / "n.png")


def test_duck_mesh_matches_jax_loader(meshes):
    mesh_p, mesh_j = meshes
    assert (mesh_p.nb_faces, mesh_p.nb_vertices, mesh_p.nb_colors) == (4212, 2108, 3)
    np.testing.assert_array_equal(mesh_p.faces, np.asarray(mesh_j.faces))
    np.testing.assert_array_equal(mesh_p.faces_uv, np.asarray(mesh_j.faces_uv))
    np.testing.assert_array_equal(mesh_p.vertices.numpy(), np.asarray(mesh_j.vertices))
    np.testing.assert_array_equal(mesh_p.uv.numpy(), np.asarray(mesh_j.uv))
    # the texture through the port's PNG reader and through the JAX package's imaging library
    assert tuple(mesh_p.texture.shape) == (512, 512, 3)
    np.testing.assert_array_equal(mesh_p.texture.numpy(), np.asarray(mesh_j.texture))
    assert mesh_p.clockwise == mesh_j.clockwise and mesh_p.textured


def test_read_and_save_obj_round_trip(tmp_path):
    faces, vertices = read_obj(DUCK)
    assert faces.shape == (4212, 3) and vertices.shape[1] == 3
    save_obj(str(tmp_path / "d.obj"), vertices, faces)
    faces2, vertices2 = read_obj(str(tmp_path / "d.obj"))
    np.testing.assert_array_equal(faces, faces2)
    np.testing.assert_allclose(vertices, vertices2, atol=1e-6)


# ------------------------------------------------- camera, adjacency, normals


def test_camera_matches_jax(meshes):
    mesh_p, mesh_j = meshes
    cam_p = default_camera(640, 480, 60, mesh_p.vertices.numpy(), ROT)
    cam_j = jax_default_camera(640, 480, 60, np.asarray(mesh_j.vertices), ROT)
    np.testing.assert_array_equal(cam_p.extrinsic, cam_j.extrinsic)
    np.testing.assert_array_equal(cam_p.intrinsic, cam_j.intrinsic)
    np.testing.assert_array_equal(cam_p.get_center(), cam_j.get_center())
    assert (cam_p.height, cam_p.width) == (480, 640)
    ij_p, z_p = cam_p.project_points(mesh_p.vertices)
    ij_j, z_j = cam_j.project_points(mesh_j.vertices)
    assert np.abs(ij_p.numpy() - np.asarray(ij_j)).max() <= 1e-10
    assert np.abs(z_p.numpy() - np.asarray(z_j)).max() <= 1e-12
    # with lens distortion, and differentiable
    dist = np.array([0.1, -0.05, 0.01, 0.02, 0.003])
    cam_pd = default_camera(640, 480, 60, mesh_p.vertices.numpy(), ROT, distortion=dist)
    cam_jd = jax_default_camera(640, 480, 60, np.asarray(mesh_j.vertices), ROT, distortion=dist)
    v = mesh_p.vertices.clone().requires_grad_(True)
    ij_pd = cam_pd.project_points(v, return_depths=False)
    assert np.abs(ij_pd.detach().numpy() - np.asarray(cam_jd.project_points(mesh_j.vertices)[0])).max() <= 1e-9
    (g,) = torch.autograd.grad(ij_pd.sum(), v)
    assert torch.isfinite(g).all() and g.abs().max() > 0
    with pytest.raises(ValueError):
        default_camera(640, 480, 60, mesh_p.vertices.numpy(), 2.0 * ROT)


def test_importing_the_port_leaves_tf32_switches_alone():
    """The port sets none of PyTorch's global switches: TF32 turned on
    before importing it (the package, its scene and its camera) is still on
    after."""
    import subprocess
    import sys

    code = ("import torch\n"
            "torch.backends.cuda.matmul.allow_tf32 = True\n"
            "torch.backends.cudnn.allow_tf32 = True\n"
            "import deodr_tpu_torch, deodr_tpu_torch.scene, deodr_tpu_torch.camera\n"
            "print(torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True, timeout=120, check=True)
    assert out.stdout.split() == ["True", "True"]


def test_adjacency_and_normals_match_jax(meshes, jax_duck):
    mesh_p, mesh_j = meshes
    adj_p, adj_j = mesh_p.adjacencies, mesh_j.adjacencies
    for name in ("edges", "edge_faces", "faces_edges", "edge_nb_faces", "degree_v_e", "degree_v_f"):
        np.testing.assert_array_equal(getattr(adj_p, name), getattr(adj_j, name), err_msg=name)
    for name in ("nb_edges", "is_manifold", "is_closed", "has_boundaries"):
        assert getattr(adj_p, name) == getattr(adj_j, name), name
    np.testing.assert_array_equal(adj_p.boundary_edges(), adj_j.boundary_edges())
    assert np.abs(mesh_p.face_normals.numpy() - np.asarray(mesh_j.face_normals)).max() <= 1e-12
    assert np.abs(mesh_p.vertex_normals.numpy() - np.asarray(mesh_j.vertex_normals)).max() <= 1e-12
    _, camera_j, _ = jax_duck
    ij_j = camera_j.project_points(mesh_j.vertices, return_depths=False)
    ij_p = torch.from_numpy(np.array(ij_j))
    np.testing.assert_array_equal(adj_p.face_visible(ij_p).numpy(), np.asarray(adj_j.face_visible(ij_j)))
    sil_p = mesh_p.edge_on_silhouette(ij_p).numpy()
    np.testing.assert_array_equal(sil_p, np.asarray(mesh_j.edge_on_silhouette(ij_j)))
    assert sil_p.any() and not sil_p.all()
    if adj_p.is_closed:
        assert float(mesh_p.compute_volume()) == pytest.approx(float(mesh_j.compute_volume()), rel=1e-12)


# ------------------------------------------------------------ the duck scene


def test_duck_scene_fields_match_scene3d_buffers(jax_duck):
    _, _, buffers = jax_duck
    fields = duck_scene.duck_scene_fields()
    assert set(fields) == {f.name for f in dataclasses.fields(buffers)}
    for name, value in fields.items():
        ref = getattr(buffers, name)
        if isinstance(value, np.ndarray):
            ref = np.asarray(ref)
            assert value.shape == ref.shape, name
            if value.dtype == np.float32:
                scale = max(float(np.abs(ref).max()), 1e-30)
                assert np.abs(value - ref).max() <= 1e-6 * scale, name
            else:
                np.testing.assert_array_equal(value, ref, err_msg=name)
        else:
            assert value == ref or (value is None and ref is None), name
    assert fields["edgeflags"].sum() > 100 and fields["texture"].shape == (512, 512, 3)
    # through scene_buffers_from_numpy: every field arrives, with the port's types
    scene = scene_buffers_from_numpy(fields, device="cpu", dtype=torch.float32)
    for name in ("uv", "shade", "texture", "ij", "depths", "colors", "background_color"):
        t = getattr(scene, name)
        assert t.dtype == torch.float32 and np.array_equal(t.numpy(), fields[name]), name
    for name in ("faces", "faces_uv"):
        t = getattr(scene, name)
        assert t.dtype == torch.int64 and np.array_equal(t.numpy(), fields[name]), name
    for name in ("textured", "shaded", "edgeflags"):
        t = getattr(scene, name)
        assert t.dtype == torch.bool and np.array_equal(t.numpy(), fields[name]), name
    assert (scene.height, scene.width, scene.background_image) == (480, 640, None)


def test_duck_plan_constants_match_jax_planner(jax_duck):
    scene_j, camera_j, _ = jax_duck
    cap, tiling, aa_window, aa_tex_window, tex_plan = scene_j._eager_plan(camera_j)
    assert cap == duck_scene.DUCK_AA_EDGE_CAPACITY
    # aa_window / aa_tex_window serve the sequential edge pass only: with a tiling and a
    # texture plan the JAX render_scene does not read them, and the port does not take them
    del aa_window, aa_tex_window
    for name in duck_scene.DUCK_TILING._fields:
        if name != "edge_capacity":
            assert getattr(duck_scene.DUCK_TILING, name) == getattr(tiling, name), name
    # the planner sizes edge_capacity from whole edges; the textured pass bins their segments,
    # which overflow it on this view (test_duck_plan_holds_its_counts), so the port's is larger
    assert tiling.edge_capacity == 64 < duck_scene.DUCK_TILING.edge_capacity
    for name in duck_scene.DUCK_TEX_PLAN._fields:
        assert getattr(duck_scene.DUCK_TEX_PLAN, name) == getattr(tex_plan, name), name
    assert not scene_j.perspective_correct and duck_scene.DUCK_SIGMA == scene_j.sigma


def test_duck_plan_holds_its_counts():
    """The plan's capacities against the duck's own counts, without
    rendering: drawn triangles, active silhouette edges, the segments
    ``split_edges`` makes of them, and the segment bands per edge tile
    (before the occlusion cull, so an upper bound)."""
    from deodr_tpu_torch.ops.render import _build_edge_data, prepare
    from deodr_tpu_torch.ops.tiled import _edge_band_tile_mask, _grid, compact_active_edges, split_edges

    scene = scene_buffers_from_numpy(duck_scene.duck_scene_fields(), device="cpu", dtype=torch.float32)
    ij_off, signed_area, draw, _ = prepare(scene)
    assert 0 < int(draw.sum()) <= duck_scene.DUCK_TILING.drawn_capacity
    checks = []
    edges = _build_edge_data(scene, ij_off, signed_area, duck_scene.DUCK_AA_EDGE_CAPACITY, checks)
    assert 0 < int(checks[0][1]) <= duck_scene.DUCK_AA_EDGE_CAPACITY
    assert edges.use_texture.all() and edges.uvs.abs().max() > 0
    plan = duck_scene.DUCK_TEX_PLAN
    segments = split_edges(edges, plan.n_split, None, uv_segment_length=plan.uv_segment_length)
    assert int(edges.active.sum()) < int(segments.active.sum()) <= plan.seg_capacity
    segments = compact_active_edges(segments, plan.seg_capacity)
    tiling = duck_scene.DUCK_TILING
    grid = _grid(480, 640, tiling.edge_tile_h, tiling.tile_w)
    per_tile = {}
    for name, e in (("edges", edges), ("segments", segments)):
        mask = _edge_band_tile_mask(e.v0, e.v1, duck_scene.DUCK_SIGMA, e.active, grid, 480, 640)
        per_tile[name] = int(mask.sum(dim=1).max())
    # the JAX planner's edge_capacity of 64 holds the whole edges, not their segments
    assert per_tile["edges"] <= 64 < per_tile["segments"] <= tiling.edge_capacity
