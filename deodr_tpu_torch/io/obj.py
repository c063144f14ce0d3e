"""Wavefront OBJ I/O (numpy).

Counterpart of ``deodr_tpu/io/obj.py``: ``read_obj`` / ``save_obj`` are the
minimal vertex-and-face parser and writer; ``load_obj_mesh`` also parses
texture coordinates and the material's diffuse texture map, so a textured
mesh (the duck) loads without any mesh or imaging library. The texture is
read by :mod:`deodr_tpu_torch.io.png`.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

from deodr_tpu_torch.io.png import read_png


def read_obj(filename: str) -> Tuple[np.ndarray, np.ndarray]:
    """Minimal OBJ loader: only ``v`` and ``f`` keywords, returns (faces, vertices).

    Handles negative (relative) vertex indices.
    """
    faces: List[np.ndarray] = []
    vertices: List[np.ndarray] = []
    with open(filename, "r") as fid:
        node_counter = 0
        for raw in _logical_lines(fid):
            if raw.startswith("v "):
                coord = raw.split()[1:]
                node_counter += 1
                vertices.append(np.array([float(c) for c in coord]))
            elif raw.startswith("f "):
                fields = raw.split()[1:]
                cleaned: List[int] = []
                for f in fields:
                    v = int(f.split("/")[0]) - 1
                    if v < 0:
                        v = node_counter + v + 1
                    cleaned.append(v)
                faces.append(np.array(cleaned))
    return np.vstack(faces), np.vstack(vertices)


def save_obj(filename: str, vertices: np.ndarray, faces: np.ndarray) -> None:
    vertices = np.asarray(vertices)
    faces = np.asarray(faces)
    with open(filename, "w") as f:
        for vertex in vertices:
            f.write(f"v {vertex[0]:08f} {vertex[1]:08f} {vertex[2]:08f}\n")
        for face in faces:
            f.write(f"f {face[0] + 1} {face[1] + 1} {face[2] + 1}\n")


def _logical_lines(fid):
    """Yield lines with trailing-backslash continuations joined."""
    for line in fid:
        line = line.rstrip("\n")
        while line.endswith("\\"):
            line = line[:-1] + next(fid).rstrip("\n")
        yield line


def load_obj_mesh(filename: str):
    """Full OBJ loader returning a ColoredTriMesh (with texture if present).

    Parses v / vt / f v[/vt[/vn]] and resolves the diffuse texture map
    (``map_Kd``, a PNG file) from the companion .mtl file. UVs are converted
    from OpenGL-style [0, 1] v-up coordinates to this package's
    integer-texel-center pixel coordinates. Identical 3D vertex positions
    are merged, so the surface stays manifold for silhouette detection while
    the uv topology stays separate.
    """
    from deodr_tpu_torch.geometry.mesh import ColoredTriMesh

    vertices: List[List[float]] = []
    uvs: List[List[float]] = []
    faces: List[List[int]] = []
    faces_uv: List[List[int]] = []
    mtl_file: Optional[str] = None

    with open(filename, "r") as fid:
        for line in _logical_lines(fid):
            parts = line.split()
            if not parts:
                continue
            key = parts[0]
            if key == "v":
                vertices.append([float(c) for c in parts[1:4]])
            elif key == "vt":
                uvs.append([float(c) for c in parts[1:3]])
            elif key == "f":
                vi, ti = [], []
                for field in parts[1:]:
                    comps = field.split("/")
                    v = int(comps[0])
                    v = v - 1 if v > 0 else len(vertices) + v
                    vi.append(v)
                    if len(comps) > 1 and comps[1] != "":
                        t = int(comps[1])
                        ti.append(t - 1 if t > 0 else len(uvs) + t)
                # fan-triangulate polygons
                for k in range(1, len(vi) - 1):
                    faces.append([vi[0], vi[k], vi[k + 1]])
                    if ti:
                        faces_uv.append([ti[0], ti[k], ti[k + 1]])
            elif key == "mtllib":
                mtl_file = os.path.join(os.path.dirname(filename), parts[1])

    vertices_np = np.array(vertices, dtype=np.float64)
    faces_np = np.array(faces, dtype=np.int64)

    texture = None
    if mtl_file is not None and os.path.exists(mtl_file):
        with open(mtl_file, "r") as fid:
            for line in fid:
                parts = line.split()
                if parts and parts[0] == "map_Kd":
                    tex_path = os.path.join(os.path.dirname(mtl_file), parts[1])
                    if os.path.exists(tex_path):
                        texture = read_png(tex_path).astype(np.float64) / 255
                        if texture.ndim == 3 and texture.shape[2] == 4:
                            texture = texture[:, :, :3]

    uv = None
    faces_uv_np = None
    if uvs and faces_uv and texture is not None:
        uv_raw = np.array(uvs, dtype=np.float64)
        uv = np.column_stack((uv_raw[:, 0] * texture.shape[1], (1 - uv_raw[:, 1]) * texture.shape[0])) - 0.5
        faces_uv_np = np.array(faces_uv, dtype=np.int64)
    else:
        texture = None

    # merge identical 3D vertices (uv topology kept separate)
    merged, _, inv_ids = np.unique(vertices_np, axis=0, return_index=True, return_inverse=True)
    merged_faces = inv_ids.reshape(-1)[faces_np].astype(np.int32)

    if texture is not None:
        return ColoredTriMesh(merged_faces, merged, faces_uv=faces_uv_np, uv=uv, texture=texture)
    colors = np.ones((merged.shape[0], 3)) * 0.5
    return ColoredTriMesh(merged_faces, merged, colors=colors)
