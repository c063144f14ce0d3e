"""The duck scene: the repository's textured flagship configuration, as
numpy ``SceneBuffers`` fields with its static render plan.

``duck_scene_fields`` builds what the JAX package's ``bench.measure_duck``
renders: the duck mesh (``data/duck.obj``, 4212 faces, a 512² texture) seen
by ``default_camera(640, 480, 60°)`` rotated by diag(1, −1, −1), Gouraud
shade from a directional light [-0.4, -0.4, -0.8] plus ambient 0.4,
background [0.2, 0.3, 0.5], silhouette edges flagged for σ > 0. Hand the
fields to :func:`deodr_tpu_torch.scene_buffers_from_numpy` and render with
the ``DUCK_*`` plan below, which is what the JAX package's planner
(``Scene3D(impl="pallas")._eager_plan``) gives for this view at σ = 1, but
for ``edge_capacity``: the planner sizes it from whole edges (at most 42
bands in a tile, 64 with its margin), while the textured edge pass bins the
segments that ``split_edges`` makes of them, and two tiles of this view hold
68. With 64 those tiles drop segments silently; 128 is the planner's rule
(margin 1.5, next power of two) applied to the segment count.
"""

from __future__ import annotations

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
    tile_h=16, tile_w=128, triangle_capacity=256, edge_capacity=128, drawn_capacity=2048, edge_tile_h=8
)
DUCK_TEX_PLAN = EdgeTexPlan(n_split=16, seg_capacity=1024, uv_segment_length=6.0)

LIGHT_DIRECTIONAL = (-0.4, -0.4, -0.8)
LIGHT_AMBIENT = 0.4
BACKGROUND_COLOR = (0.2, 0.3, 0.5)


def luminosity(mesh: ColoredTriMesh, vertices: torch.Tensor, light_directional, light_ambient) -> torch.Tensor:
    """Per-vertex Gouraud shade max(0, −⟨n, l⟩) + ambient, n the vertex
    normals."""
    adj = mesh.adjacencies
    normals = adj.compute_vertex_normals(adj.compute_face_normals(vertices))
    light = torch.as_tensor(light_directional, dtype=vertices.dtype, device=vertices.device)
    return torch.clamp_min(-(normals * light).sum(dim=1), 0.0) + light_ambient


def duck_scene_fields() -> dict:
    """The duck scene as the float32 / int32 fields and meta fields of
    ``SceneBuffers`` (projection, normals and silhouette flags are computed
    in float64 on the CPU)."""
    mesh = ColoredTriMesh.load(str(DATA_PATH / "duck.obj"))
    camera = default_camera(DUCK_WIDTH, DUCK_HEIGHT, 60, mesh.vertices.numpy(), np.diag([1.0, -1.0, -1.0]))
    vertices = mesh.vertices
    points_2d, depths = camera.project_points(vertices)
    edgeflags = mesh.edge_on_silhouette(points_2d).numpy()
    shade = luminosity(mesh, vertices, LIGHT_DIRECTIONAL, LIGHT_AMBIENT)
    return dict(
        faces=mesh.faces,
        faces_uv=mesh.faces_uv,
        ij=points_2d.numpy().astype(np.float32),
        depths=depths.numpy().astype(np.float32),
        uv=mesh.uv.numpy().astype(np.float32),
        shade=shade.numpy().astype(np.float32),
        colors=np.zeros((mesh.nb_vertices, mesh.nb_colors), np.float32),
        edgeflags=edgeflags,
        textured=np.ones((mesh.nb_faces,), bool),
        shaded=np.ones((mesh.nb_faces,), bool),
        texture=mesh.texture.numpy().astype(np.float32),
        background_image=None,
        background_color=np.array(BACKGROUND_COLOR, np.float32),
        height=DUCK_HEIGHT,
        width=DUCK_WIDTH,
        clockwise=mesh.clockwise,
        backface_culling=True,
        strict_edge=True,
        perspective_correct=False,
        integer_pixel_centers=True,
    )
