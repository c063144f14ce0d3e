"""Triangle mesh classes: static topology (numpy), geometry as tensors.

PyTorch counterpart of ``deodr_tpu/geometry/mesh.py`` without its
conversion and plotting helpers: ``TriMesh``, ``ColoredTriMesh`` and
``ColoredTriMesh.load`` for Wavefront OBJ files.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from deodr_tpu_torch.geometry.adjacency import TriMeshAdjacencies


def _as_tensor(a) -> Optional[torch.Tensor]:
    if a is None or isinstance(a, torch.Tensor):
        return a
    return torch.from_numpy(np.ascontiguousarray(a))


class TriMesh:
    """A triangulated mesh with static topology; ``vertices`` is a tensor
    (a numpy array is taken over as a CPU tensor of its dtype)."""

    def __init__(self, faces, vertices, clockwise: bool = False, compute_adjacencies: bool = True):
        faces = np.asarray(faces)
        if faces.ndim != 2 or faces.shape[1] != 3 or not np.issubdtype(faces.dtype, np.integer):
            raise ValueError("faces must be an integer (F, 3) array")
        self._faces = faces.astype(np.int32)
        self.nb_vertices = int(vertices.shape[0])
        self.nb_faces = int(faces.shape[0])
        self.clockwise = clockwise
        self._adjacencies: Optional[TriMeshAdjacencies] = None
        self.set_vertices(vertices)
        if compute_adjacencies:
            self.compute_adjacencies()

    def compute_adjacencies(self) -> None:
        self._adjacencies = TriMeshAdjacencies(self._faces, self.clockwise, nb_vertices=self.nb_vertices)
        if self._adjacencies.is_closed:
            self.check_orientation()

    @property
    def faces(self) -> np.ndarray:
        return self._faces

    @property
    def vertices(self) -> torch.Tensor:
        return self._vertices

    @property
    def adjacencies(self) -> TriMeshAdjacencies:
        if self._adjacencies is None:
            self.compute_adjacencies()
        return self._adjacencies

    def set_vertices(self, vertices) -> None:
        vertices = _as_tensor(vertices)
        if vertices.ndim != 2 or vertices.shape[1] != 3:
            raise ValueError("vertices must be (V, 3)")
        self._vertices = vertices
        self._face_normals = None
        self._vertex_normals = None

    def compute_volume(self) -> torch.Tensor:
        """Signed volume of a closed manifold surface."""
        if not self.adjacencies.is_closed:
            raise ValueError("The volume can only be computed for closed manifold surfaces")
        tri = self._vertices[self.adjacencies._index("faces", self._vertices.device)]
        dets = (tri[:, 0, :] * torch.linalg.cross(tri[:, 1, :], tri[:, 2, :], dim=1)).sum(dim=1)
        return (-1 if self.clockwise else 1) * dets.sum() / 6

    def check_orientation(self) -> None:
        if float(self.compute_volume()) < 0:
            raise ValueError(
                "The volume within the surface is negative. It seems that your faces "
                "are not oriented correctly according to the clockwise flag"
            )

    @property
    def face_normals(self) -> torch.Tensor:
        if self._face_normals is None:
            self._face_normals = self.adjacencies.compute_face_normals(self._vertices)
        return self._face_normals

    @property
    def vertex_normals(self) -> torch.Tensor:
        if self._vertex_normals is None:
            self._vertex_normals = self.adjacencies.compute_vertex_normals(self.face_normals)
        return self._vertex_normals

    def edge_on_silhouette(self, points_2d: torch.Tensor) -> torch.Tensor:
        if not self.adjacencies.is_manifold:
            raise ValueError("silhouette edges need a manifold mesh")
        return self.adjacencies.edge_on_silhouette(points_2d)


class ColoredTriMesh(TriMesh):
    """TriMesh with per-vertex colors or a UV-mapped texture."""

    def __init__(
        self,
        faces,
        vertices,
        clockwise: bool = False,
        faces_uv=None,
        uv=None,
        texture=None,
        colors=None,
        nb_colors: Optional[int] = None,
        compute_adjacencies: bool = True,
    ):
        super().__init__(faces, vertices, clockwise=clockwise, compute_adjacencies=compute_adjacencies)
        self.faces_uv = faces_uv
        self.uv = _as_tensor(uv)
        self.texture = _as_tensor(texture)
        self.vertices_colors = _as_tensor(colors)
        self.textured = self.texture is not None
        if nb_colors is None:
            if texture is None:
                if colors is None:
                    raise ValueError("Provide one of nb_colors, texture or colors")
                nb_colors = int(self.vertices_colors.shape[1])
            else:
                nb_colors = int(self.texture.shape[2])
        self.nb_colors = nb_colors

    @property
    def faces_uv(self) -> Optional[np.ndarray]:
        return self._faces_uv

    @faces_uv.setter
    def faces_uv(self, faces_uv) -> None:
        self._faces_uv = None if faces_uv is None else np.asarray(faces_uv).astype(np.int32)
        self._faces_uv_on_device: dict = {}  # device → int64 index tensor

    def _index(self, name: str, device) -> torch.Tensor:
        """``faces`` or ``faces_uv`` (the faces where the mesh has no uv
        faces of its own) as an int64 tensor on ``device``, copied there
        once and kept with the mesh."""
        if name == "faces_uv" and self._faces_uv is not None:
            key = torch.device(device)
            if key not in self._faces_uv_on_device:
                self._faces_uv_on_device[key] = torch.as_tensor(self._faces_uv.astype(np.int64), device=device)
            return self._faces_uv_on_device[key]
        return self.adjacencies._index("faces", device)

    def set_vertices_colors(self, colors) -> None:
        self.vertices_colors = _as_tensor(colors)

    @staticmethod
    def load(filename: str) -> "ColoredTriMesh":
        """Load a Wavefront OBJ file with its texture, if it has one."""
        if not filename.lower().endswith(".obj"):
            raise ValueError(f"only Wavefront .obj files are read, got {filename}")
        from deodr_tpu_torch.io.obj import load_obj_mesh

        return load_obj_mesh(filename)
