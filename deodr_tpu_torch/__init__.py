"""deodr_tpu_torch: the PyTorch / CUDA port of deodr_tpu.

A differentiable triangle-mesh rasterizer (discontinuity-edge-overdraw
antialiasing) on an NVIDIA GPU: ``render_scene`` and its autograd
gradients with respect to vertex positions, colors, texture coordinates,
shade and texture, tiled (the per-pixel loops of the solid and edge passes
in hand-written CUDA kernels, ``csrc/``) or untiled. The scene classes of
the JAX package sit on top: ``Scene2D`` (projected 2D vertices as numpy
arrays, gradients accumulated into numpy buffers) and ``Scene3D`` (one mesh
and its lights; render, backward, depth and the G-buffer
``render_deferred``). Entry points run where the scene's tensors live;
scenes are made on ``cuda`` unless the caller asks for the CPU, where every
kernel runs its plain PyTorch version. The package sets none of PyTorch's
global switches. The fitters (``deodr_tpu_torch.mesh_fitter``) fit a mesh
to a depth image, an RGB image or several views through it, and
``deodr_tpu_torch.examples`` holds the JAX package's examples on the port;
``data_path`` is the repository's ``data/`` folder, which holds their
inputs. ``deodr_tpu_torch.parallel`` scales out over ``torch.distributed``
(a ("views", "tiles") device mesh, tile-sharded rendering, view-parallel
steps; its four public names are exported here too), and
``deodr_tpu_torch.profiling`` gives per-kernel device times.
"""

import os as _os

data_path = _os.path.abspath(_os.path.join(_os.path.dirname(__file__), "..", "data"))

from deodr_tpu_torch.camera import Camera, PerspectiveCamera, default_camera
from deodr_tpu_torch.geometry.energy import LaplacianRigidEnergy
from deodr_tpu_torch.geometry.mesh import ColoredTriMesh, TriMesh, TriMeshAdjacencies
from deodr_tpu_torch.geometry.subdivision import loop_subdivision
from deodr_tpu_torch.io.obj import read_obj, save_obj
from deodr_tpu_torch.mesh_fitter import (
    MeshDepthFitter,
    MeshDepthFitterEnergy,
    MeshRGBFitterWithPose,
    MeshRGBFitterWithPoseMultiFrame,
)
from deodr_tpu_torch.ops.render import (
    SceneBuffers,
    render_scene,
    render_scene_batch,
    scene_buffers_from_numpy,
    validate_capacities,
)
from deodr_tpu_torch.ops.tiled import EdgeTexPlan, TilingConfig, suggest_tiling
from deodr_tpu_torch.parallel import (
    make_device_mesh,
    make_textured_multiview_step,
    multiview_train_step,
    shard_render_scene,
)
from deodr_tpu_torch.scene import Scene2D, Scene3D

__version__ = "0.1.0"

__all__ = [
    "Camera", "ColoredTriMesh", "EdgeTexPlan", "LaplacianRigidEnergy", "MeshDepthFitter", "MeshDepthFitterEnergy",
    "MeshRGBFitterWithPose", "MeshRGBFitterWithPoseMultiFrame", "PerspectiveCamera", "Scene2D", "Scene3D",
    "SceneBuffers", "TilingConfig", "TriMesh", "TriMeshAdjacencies", "data_path", "default_camera",
    "loop_subdivision", "make_device_mesh", "make_textured_multiview_step", "multiview_train_step", "read_obj",
    "render_scene", "render_scene_batch", "save_obj", "scene_buffers_from_numpy", "shard_render_scene",
    "suggest_tiling", "validate_capacities",
]
