"""The port's ``Scene3D`` (deodr_tpu_torch.scene) on an untextured mesh
against the JAX package's on the CPU, in float64, the torus of
tests/torch_port_scenes.py with per-vertex colors (96×128, σ = 1):

- ``render`` + ``render_backward``: colors = vertex colors × luminosity,
  gradients to the vertices, the vertex colors (``vertices_colors_b``) and
  the light, against ``_eager_plan`` + ``_build_buffers`` +
  ``render_scene(impl="pallas", impl_interpret=True)`` + ``jax.vjp``;
- ``render_depth`` + ``render_depth_backward`` (the depth × scale branch of
  ``_build_buffers``) against the same JAX path;
- image and z within 1e-9, gradients within 1e-9 of their scale;
- one scene rendering two meshes in turn: each image is the one a scene of
  that mesh alone renders.

A file of its own, so that each Scene3D file keeps to its time on one
worker.
"""

import numpy as np
import pytest
import torch

from deodr_tpu_torch.geometry.mesh import ColoredTriMesh
from deodr_tpu_torch.scene import Scene3D
from test_torch_port_scene3d import LIGHT, _cameras, _meshes, _scenes, check_scene3d_against_jax
from torch_port_scenes import torus_arrays


@pytest.mark.parametrize("depth_scale", [None, 0.5], ids=["colors", "depth"])
def test_scene3d_untextured_render_and_backward_match_jax(depth_scale):
    mesh_p, mesh_j = _meshes(textured=False)
    scene_p, scene_j = _scenes(mesh_p, mesh_j, 1.0)
    if depth_scale is not None:
        for s in (scene_p, scene_j):
            s.background_color = np.array([5.0])
    camera_p, camera_j = _cameras()
    plan = scene_p._eager_plan(camera_p)
    assert plan[0] is not None and plan[1] is not None and plan[4] is None  # an untextured σ = 1 tiled plan
    g = check_scene3d_against_jax(scene_p, scene_j, camera_p, camera_j, depth_scale=depth_scale)
    assert set(g) == {"vertices", "vertices_colors", "light_directional", "light_ambient"}
    assert np.abs(g["vertices"]).max() > 0
    if depth_scale is None:
        assert all(np.abs(g[k]).max() > 0 for k in g)
    else:  # the depth image reads only the vertices
        assert all(np.abs(g[k]).max() == 0 for k in ("vertices_colors", "light_directional", "light_ambient"))


def test_scene3d_renders_two_meshes_in_turn():
    """set_mesh with another mesh of the same sizes, then back: the index
    tensors and the plan follow the mesh."""

    def mesh(seed, reverse):
        a = torus_arrays(False, seed=seed)
        faces = a["faces"][::-1].copy() if reverse else a["faces"]
        return ColoredTriMesh(faces, torch.from_numpy(a["vertices"]), colors=a["colors"])

    camera, _ = _cameras()
    meshes = [mesh(0, False), mesh(1, True)]
    alone = []
    for m in meshes:
        s = Scene3D(sigma=1.0, device="cpu")
        s.set_mesh(m)
        s.set_light(*LIGHT)
        s.set_background_color(np.zeros(3))
        alone.append(s.render(camera, check_capacity=True))
    assert float((alone[0] - alone[1]).abs().max()) > 0.1
    scene = Scene3D(sigma=1.0, device="cpu")
    scene.set_light(*LIGHT)
    scene.set_background_color(np.zeros(3))
    for k in (0, 1, 0, 1):
        scene.set_mesh(meshes[k])
        assert torch.equal(scene.render(camera, check_capacity=True), alone[k])
