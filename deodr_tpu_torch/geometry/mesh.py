"""Triangle mesh classes: static topology (numpy), geometry as tensors.

PyTorch counterpart of ``deodr_tpu/geometry/mesh.py``: ``TriMesh``,
``ColoredTriMesh``, ``ColoredTriMesh.subdivise`` (Loop subdivision), the
conversions from and to ``trimesh`` (in numpy, on objects with trimesh's
attributes; ``trimesh`` itself is imported only by ``to_trimesh`` and
``load``) and ``ColoredTriMesh.load``, which reads Wavefront OBJ files
without ``trimesh``.
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

    def subdivise(self, n_iter: int) -> "ColoredTriMesh":
        """The mesh after ``n_iter`` Loop subdivisions (itself for 0)."""
        from deodr_tpu_torch.geometry.subdivision import loop_subdivision

        return loop_subdivision(self, n_iter)

    def plot_uv_map(self, ax) -> None:
        """Draw the texture with the UV triangulation over it on the
        matplotlib axis ``ax`` (the reference's
        ``deodr/triangulated_mesh.py:343-347``)."""
        if self.uv is None:
            raise ValueError("You need to provide a uv to display the uv map")
        uv = self.uv.detach().cpu().numpy()
        if self.texture is not None:
            ax.imshow(self.texture.detach().cpu().numpy())
        ax.triplot(uv[:, 0], uv[:, 1], self.faces_uv)

    def plot(self, ax) -> None:
        """3D surface with the vertex normals as arrows on the matplotlib 3D
        axis ``ax`` (the reference's ``deodr/triangulated_mesh.py:349-359``)."""
        v = self.vertices.detach().cpu().numpy()
        u, w, n = self.vertex_normals.detach().cpu().numpy().T
        ax.plot_trisurf(v[:, 0], v[:, 1], Z=v[:, 2], triangles=self.faces)
        ax.quiver(v[:, 0], v[:, 1], v[:, 2], u, w, n, length=0.03, normalize=True, color=[0, 1, 0])

    @staticmethod
    def from_trimesh(mesh, compute_adjacencies: bool = True) -> "ColoredTriMesh":
        """The mesh of a ``trimesh.Trimesh`` (any object with its
        ``vertices``, ``faces`` and ``visual`` attributes), re-merging the
        vertices that a UV seam split so that the surface stays manifold
        (the reference's ``deodr/triangulated_mesh.py:368-439``)."""
        colors = None
        uv = None
        texture = None
        if mesh.visual.kind == "vertex":
            colors = np.asarray(mesh.visual.vertex_colors).copy()
            if colors.ndim == 2 and colors.shape[1] == 4:
                colors = colors[:, :3]
            colors = colors.astype(np.float64) / 255
        elif mesh.visual.kind == "face":
            raise ValueError("per-face colors not supported (would need antialiasing at the seams)")
        elif mesh.visual.kind == "texture" and mesh.visual.uv is not None:
            texture = np.array(mesh.visual.material.image) / 255
            if texture.ndim == 3 and texture.shape[2] == 4:
                texture = texture[:, :, :3]
            # OpenGL uv in [0, 1] with v up → pixel uv with integer texel
            # centres and the origin at the upper-left texel
            uv = (
                np.column_stack(
                    (mesh.visual.uv[:, 0] * texture.shape[1], (1 - mesh.visual.uv[:, 1]) * texture.shape[0])
                )
                - 0.5
            )

        vertices, return_index, inv_ids = np.unique(mesh.vertices, axis=0, return_index=True, return_inverse=True)
        inv_ids = inv_ids.reshape(-1)
        faces = inv_ids[mesh.faces].astype(np.int32)
        if colors is not None:
            colors2 = colors[return_index, :]
            if np.any(colors != colors2[inv_ids, :]):
                raise ValueError(
                    "vertices at the same 3D location should have the same color "
                    "for the rendering to be differentiable"
                )
        else:
            colors2 = None
        return ColoredTriMesh(
            faces,
            vertices,
            clockwise=False,
            faces_uv=np.asarray(mesh.faces),
            uv=uv,
            texture=texture,
            colors=colors2,
            compute_adjacencies=compute_adjacencies,
        )

    def to_trimesh(self):
        """The mesh as a ``trimesh.Trimesh`` with a texture (textured meshes
        only; the reference's ``deodr/triangulated_mesh.py:441-478``).
        Needs ``trimesh`` and ``PIL``."""
        import PIL.Image
        import trimesh

        if self.vertices_colors is not None:
            raise ValueError("Conversion to trimesh with per-vertex color not supported yet")
        assert self.uv is not None and self.texture is not None, "Only meshes with texture supported."
        v = self.vertices.detach().cpu().numpy()
        uv_np = self.uv.detach().cpu().numpy()
        tex_np = self.texture.detach().cpu().numpy()
        vt = np.column_stack(
            ((uv_np[:, 0] + 0.5) / tex_np.shape[1], 1 - ((uv_np[:, 1] + 0.5) / tex_np.shape[0]))
        )
        new_faces, mask_v, mask_vt = trimesh.visual.texture.unmerge_faces(self.faces, self.faces_uv)
        new_vertices = v[mask_v].copy()
        uv2 = vt[mask_vt].copy()
        texture_uint8 = np.clip(tex_np * 255, 0, 255).astype(np.uint8)
        if texture_uint8.shape[2] == 1:
            texture_uint8 = texture_uint8.squeeze(axis=2)
        material = trimesh.visual.material.SimpleMaterial(image=PIL.Image.fromarray(texture_uint8))
        visual = trimesh.visual.texture.TextureVisuals(uv=uv2, material=material)
        return trimesh.Trimesh(vertices=new_vertices, faces=new_faces, visual=visual)

    @staticmethod
    def load(filename: str, process: bool = False) -> "ColoredTriMesh":
        """Load a mesh file through ``trimesh.load_mesh(filename,
        process=process)``; without ``trimesh``, a Wavefront OBJ file with
        the port's own reader (its texture too, if it has one), and any
        other file raises the ``ImportError``."""
        try:
            import trimesh
        except ImportError:
            if filename.lower().endswith(".obj"):
                from deodr_tpu_torch.io.obj import load_obj_mesh

                return load_obj_mesh(filename)
            raise
        return ColoredTriMesh.from_trimesh(trimesh.load_mesh(filename, process=process))
