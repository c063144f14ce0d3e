"""Static mesh adjacency structures.

PyTorch counterpart of ``deodr_tpu/geometry/adjacency.py``: the index
arrays (edge list, edge→face incidence, face→edge ids) are built once in
numpy at mesh construction; the per-frame operations (normals, front-facing
test, silhouette edges) are plain torch on the vertices' device, gathers
and ``index_add_`` over those static indices, differentiable by autograd,
and the graph Laplacian (``laplacian_apply``) of the rigid energy and the
subdivision.
"""

from __future__ import annotations

import numpy as np
import torch


def _normalize(x: torch.Tensor) -> torch.Tensor:
    """Rows of x over their norms. The squared norm is floored at the dtype's
    smallest normal number: a zero row (a degenerate face) stays zero, with
    finite gradients, where the bare quotient gives NaN; a row whose squared
    norm is a normal number is unchanged, bit for bit."""
    return x / torch.sqrt((x**2).sum(dim=1, keepdim=True).clamp_min(torch.finfo(x.dtype).tiny))


class TriMeshAdjacencies:
    """Adjacency index arrays of a triangle mesh:

    - ``edges``        (E, 2) int32 — unique undirected edges.
    - ``edge_faces``   (E, 2) int32 — up to two incident faces, -1 padded.
    - ``faces_edges``  (F, 3) int32 — edge id of (v0,v1), (v1,v2), (v2,v0).
    - ``degree_v_e``   (V,) — number of distinct neighbor vertices.
    - ``degree_v_f``   (V,) — number of incident faces.
    - ``vertex_faces`` (V, K) int32 — incident faces, ``nb_faces`` padded.
    """

    def __init__(self, faces, clockwise: bool = False, nb_vertices: int | None = None):
        faces = np.asarray(faces)
        if faces.ndim != 2 or faces.shape[1] != 3:
            raise ValueError("faces must be (F, 3)")
        self.faces = faces.astype(np.int32)
        self.nb_faces = int(faces.shape[0])
        self.nb_vertices = int(faces.max()) + 1 if nb_vertices is None else int(nb_vertices)
        self.clockwise = clockwise

        nf, nv = self.nb_faces, self.nb_vertices
        # half-edges in block order: all (v0,v1), all (v1,v2), all (v2,v0)
        half_edges = np.vstack((faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]))
        half_faces = np.concatenate([np.arange(nf)] * 3)
        keys = (
            np.maximum(half_edges[:, 0], half_edges[:, 1]).astype(np.uint64)
            + np.minimum(half_edges[:, 0], half_edges[:, 1]).astype(np.uint64) * np.uint64(nv)
        )
        increasing = half_edges[:, 0] < half_edges[:, 1]
        _, edge_id, counts = np.unique(keys, return_inverse=True, return_counts=True)
        edge_id = edge_id.reshape(-1)
        ne = int(edge_id.max()) + 1 if len(edge_id) else 0
        self.nb_edges = ne

        edges = np.zeros((ne, 2), dtype=np.int32)
        edges[edge_id] = half_edges  # last writer wins
        self.edges = edges

        nb_inc = np.zeros(ne)
        np.add.at(nb_inc, edge_id, increasing)
        nb_dec = np.zeros(ne)
        np.add.at(nb_dec, edge_id, ~increasing)
        self.is_manifold = bool(np.all(counts <= 2) and np.all(nb_inc <= 1) and np.all(nb_dec <= 1))
        self.is_closed = bool(self.is_manifold and np.all(counts == 2))

        # up to 2 incident faces per edge, padded with -1
        edge_faces = np.full((ne, 2), -1, dtype=np.int32)
        slot = np.zeros(ne, dtype=np.int64)
        for eid, fid in zip(edge_id, half_faces):
            s = slot[eid]
            if s < 2:
                edge_faces[eid, s] = fid
            slot[eid] = s + 1
        self.edge_faces = edge_faces
        self.edge_nb_faces = np.minimum(slot, 2).astype(np.int32)
        self.has_boundaries = bool(np.any(slot == 1))

        self.faces_edges = edge_id.reshape(3, nf).T.astype(np.int32).copy()

        deg_f = np.zeros(nv)
        np.add.at(deg_f, faces.ravel(), 1)
        self.degree_v_f = deg_f
        deg_e = np.zeros(nv)
        np.add.at(deg_e, edges.ravel(), 1)
        self.degree_v_e = deg_e

        # incident faces of each vertex in increasing face order, padded
        # with nb_faces (a zero row): a vertex normal is then a gather and a
        # sum in a fixed order, the same on every run (atomics would add in
        # another order each run, and float32 attribute maps of thin
        # triangles magnify a last-bit change of the shade)
        corners = np.argsort(faces.ravel(), kind="stable")
        corner_vertex = faces.ravel()[corners]
        per_vertex = np.bincount(corner_vertex, minlength=nv)
        rank = np.arange(len(corners)) - np.repeat(np.cumsum(per_vertex) - per_vertex, per_vertex)
        self.vertex_faces = np.full((nv, max(int(per_vertex.max(initial=0)), 1)), nf, dtype=np.int32)
        self.vertex_faces[corner_vertex, rank] = corners // 3

        self._on_device: dict = {}  # (name, device[, dtype]) → tensor

    def _index(self, name: str, device) -> torch.Tensor:
        """The index array ``name`` as an int64 tensor on ``device`` (copied
        there once)."""
        key = (name, torch.device(device))
        if key not in self._on_device:
            self._on_device[key] = torch.as_tensor(getattr(self, name).astype(np.int64), device=device)
        return self._on_device[key]

    def _float(self, name: str, like: torch.Tensor) -> torch.Tensor:
        """The float array ``name`` in the dtype and on the device of
        ``like`` (copied there once)."""
        key = (name, like.device, like.dtype)
        if key not in self._on_device:
            self._on_device[key] = torch.as_tensor(getattr(self, name), dtype=like.dtype, device=like.device)
        return self._on_device[key]

    # ---- per-frame differentiable operations --------------------------------

    def compute_face_normals(self, vertices: torch.Tensor) -> torch.Tensor:
        """Unit face normals (F, 3); a degenerate face's is zero."""
        tri = vertices[self._index("faces", vertices.device)]
        n = torch.linalg.cross(tri[:, 1, :] - tri[:, 0, :], tri[:, 2, :] - tri[:, 0, :], dim=1)
        if self.clockwise:
            n = -n
        return _normalize(n)

    def compute_vertex_normals(self, face_normals: torch.Tensor) -> torch.Tensor:
        """Non-area-weighted mean of the incident face normals, normalized;
        deterministic (see ``vertex_faces``)."""
        vertex_faces = self._index("vertex_faces", face_normals.device)
        padded = torch.cat([face_normals, face_normals.new_zeros((1, 3))])
        incident = padded.index_select(0, vertex_faces.reshape(-1)).reshape(vertex_faces.shape + (3,))
        return _normalize(incident.sum(dim=1))

    def face_visible(self, vertices_2d: torch.Tensor) -> torch.Tensor:
        """Screen-space front-facing test per face."""
        tri = vertices_2d[self._index("faces", vertices_2d.device)]
        u = tri[:, 1, :] - tri[:, 0, :]
        v = tri[:, 2, :] - tri[:, 0, :]
        c = u[:, 0] * v[:, 1] - u[:, 1] * v[:, 0]
        return c > 0 if self.clockwise else c < 0

    def edge_on_silhouette(self, vertices_2d: torch.Tensor) -> torch.Tensor:
        """(F, 3) bool: edge k of face f lies on the silhouette, that is,
        exactly one of its incident faces is front-facing in screen space."""
        visible = self.face_visible(vertices_2d)
        ef = self._index("edge_faces", vertices_2d.device)
        vis_padded = torch.where(ef >= 0, visible[ef.clamp_min(0)], False)
        edge_sil = vis_padded.sum(dim=1) == 1
        return edge_sil[self._index("faces_edges", vertices_2d.device)]

    def laplacian_apply(self, x: torch.Tensor) -> torch.Tensor:
        """Apply the (symmetric) graph Laplacian to per-vertex rows x (V, …):
        deg(v)·x_v − Σ_{u∼v} x_u, the neighbour sums an ``index_add`` over
        both directions of the edge list (float atomics on the card: the
        last bit can change from run to run)."""
        e = self._index("edges", x.device)
        neigh = torch.zeros_like(x).index_add(0, e[:, 0], x.index_select(0, e[:, 1]))
        neigh = neigh.index_add(0, e[:, 1], x.index_select(0, e[:, 0]))
        degree = self._float("degree_v_e", x)
        return degree.reshape((-1,) + (1,) * (x.ndim - 1)) * x - neigh

    def boundary_edges(self) -> np.ndarray:
        return self.edges[self.edge_nb_faces == 1]
