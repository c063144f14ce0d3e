"""The duck scene: the repository's textured flagship configuration, as
numpy ``SceneBuffers`` fields with its static render plan.

``duck_scene_fields`` builds what the JAX package's ``bench.measure_duck``
renders: the duck mesh (``data/duck.obj``, 4212 faces, a 512² texture) seen
by ``default_camera(640, 480, 60°)`` rotated by diag(1, −1, −1), Gouraud
shade from a directional light [-0.4, -0.4, -0.8] plus ambient 0.4,
background [0.2, 0.3, 0.5], silhouette edges flagged for σ > 0. Hand the
fields to :func:`deodr_tpu_torch.scene_buffers_from_numpy` and render with
the ``DUCK_*`` plan below, which is what the JAX package's planner
(``Scene3D(impl="pallas")._eager_plan``) gives for this view at σ = 1,
block-compacted texture fetch included, but for ``edge_capacity``: the JAX
planner sizes it from whole edges (at most 42 bands in a tile, 64 with its
margin), while the textured edge pass bins the segments that
``split_edges`` makes of them, and two tiles of this view hold 68. With 64
those tiles drop segments silently; 128 is the planner's rule (margin 1.5,
next power of two) applied to the segment count, which the port's planner
(:class:`deodr_tpu_torch.scene.Scene3D`) uses.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

from deodr_tpu_torch.camera import default_camera
from deodr_tpu_torch.geometry.mesh import ColoredTriMesh
from deodr_tpu_torch.ops.tiled import EdgeTexPlan, TilingConfig

DATA_PATH = Path(__file__).resolve().parents[1] / "data"

DUCK_WIDTH, DUCK_HEIGHT = 640, 480
DUCK_SIGMA = 1.0
DUCK_AA_EDGE_CAPACITY = 448
DUCK_TILING = TilingConfig(
    tile_h=16, tile_w=128, triangle_capacity=256, edge_capacity=128, drawn_capacity=2048, edge_tile_h=8,
    tex_tile_capacity=504, tex_block_w=32,
)
DUCK_TEX_PLAN = EdgeTexPlan(n_split=16, seg_capacity=1024, uv_segment_length=6.0)

LIGHT_DIRECTIONAL = (-0.4, -0.4, -0.8)
LIGHT_AMBIENT = 0.4
BACKGROUND_COLOR = (0.2, 0.3, 0.5)


def duck_scene_fields() -> dict:
    """The duck scene as the float32 / int32 fields and meta fields of
    ``SceneBuffers``, as :class:`deodr_tpu_torch.scene.Scene3D` builds them
    for this view (projection, normals, shade and silhouette flags computed
    in float64 on the CPU)."""
    from deodr_tpu_torch.scene import Scene3D

    mesh = ColoredTriMesh.load(str(DATA_PATH / "duck.obj"))
    camera = default_camera(DUCK_WIDTH, DUCK_HEIGHT, 60, mesh.vertices.numpy(), np.diag([1.0, -1.0, -1.0]))
    scene = Scene3D(sigma=DUCK_SIGMA, device="cpu")
    scene.set_mesh(mesh)
    scene.set_light(np.array(LIGHT_DIRECTIONAL), LIGHT_AMBIENT)
    scene.set_background_color(np.array(BACKGROUND_COLOR))
    with torch.no_grad():
        buffers, _ = scene._build_buffers(camera, *scene._diff_inputs(False), backface_culling=True)
    fields = {}
    for f in dataclasses.fields(buffers):
        value = getattr(buffers, f.name)
        if isinstance(value, torch.Tensor):
            value = value.detach().numpy()
            if value.dtype == np.float64:
                value = value.astype(np.float32)
            elif value.dtype == np.int64:
                value = value.astype(np.int32)
        fields[f.name] = value
    return fields
