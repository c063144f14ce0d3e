"""Loop subdivision.

PyTorch counterpart of ``deodr_tpu/geometry/subdivision.py``: the topology
work happens in numpy; the vertex and color updates are torch on the
vertices' device, with the rules of the reference:

- edge midpoints: 1/8·(Σ vertices of the ≤ 2 adjacent faces) + 1/8·(edge
  ends), for interior edges the classic 3/8·ends + 1/8·opposites rule;
- moved original vertices: (3/8·1/deg)·Σ neighbours + 5/8·self.
"""

from __future__ import annotations

import numpy as np
import torch


def loop_subdivision(mesh, n_iter: int = 1):
    """``mesh`` (a ColoredTriMesh without uv) subdivided ``n_iter`` times."""
    from deodr_tpu_torch.geometry.mesh import ColoredTriMesh

    if n_iter == 0:
        return mesh
    if n_iter > 1:
        mesh = loop_subdivision(mesh, n_iter - 1)
    if mesh.uv is not None:
        raise ValueError("Textured mesh not supported yet in subdivision.")

    adj = mesh.adjacencies
    vertices = mesh.vertices
    dev = vertices.device
    nv = adj.nb_vertices

    # per-face vertex sums, gathered onto the adjacent edges
    face_sums = vertices[adj._index("faces", dev)].sum(dim=1)  # (F, 3)
    ef = adj._index("edge_faces", dev)
    zero = vertices.new_zeros(())
    face_part = (torch.where(ef[:, 0:1] >= 0, face_sums[ef[:, 0].clamp_min(0)], zero)
                 + torch.where(ef[:, 1:2] >= 0, face_sums[ef[:, 1].clamp_min(0)], zero))
    e = adj._index("edges", dev)
    edge_mid_points = face_part / 8 + vertices[e].sum(dim=1) / 8

    # moved original vertices
    neighbor_sum = torch.zeros_like(vertices).index_add(0, e[:, 0], vertices[e[:, 1]])
    neighbor_sum = neighbor_sum.index_add(0, e[:, 1], vertices[e[:, 0]])
    beta = (3 / 8) * (1 / adj._float("degree_v_e", vertices))
    moved_points = beta[:, None] * neighbor_sum + (5 / 8) * vertices

    new_vertices = torch.cat((moved_points, edge_mid_points))

    fe = adj.faces_edges + nv  # numpy (F, 3)
    faces = adj.faces
    faces1 = np.column_stack((faces[:, 0], fe[:, 0], fe[:, 2]))
    faces2 = np.column_stack((faces[:, 1], fe[:, 1], fe[:, 0]))
    faces3 = np.column_stack((faces[:, 2], fe[:, 2], fe[:, 1]))
    faces4 = np.column_stack((fe[:, 0], fe[:, 1], fe[:, 2]))
    new_faces = np.vstack((faces1, faces2, faces3, faces4))

    new_colors = None
    if mesh.vertices_colors is not None:
        colors = mesh.vertices_colors
        new_colors = torch.cat((colors, colors[adj._index("edges", colors.device)].mean(dim=1)))
    return ColoredTriMesh(new_faces, new_vertices, colors=new_colors, nb_colors=mesh.nb_colors)
