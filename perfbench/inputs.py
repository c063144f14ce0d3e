"""The inputs of a cell, made from ``--seed`` alone.

The mesh is this file's own copy of the octahedron subdivision (Loop's
rules, as in the port's ``octahedron_mesh``, then every vertex pushed onto
the unit sphere), so a change of the port cannot change what is measured.
The configuration fixes the mesh's turn and the traffic the target image;
the seed draws the starting colour of every vertex, so every seed starts
from the same geometry and plan, and its fit pulls the mesh by the same
target with colours in another order. The target is drawn with
plain array arithmetic and is never rendered by the port. Every value is
made in float64 and rounded once to the configuration's dtype, and both
the port and the reference receive those rounded values.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Inputs(NamedTuple):
    """One fit's inputs, all in the configuration's dtype on one device."""

    faces: torch.Tensor  # (F, 3) int64
    vertices: torch.Tensor  # (V, 3) starting positions
    colors: torch.Tensor  # (V, 3) starting vertex colours
    extrinsic: torch.Tensor  # (3, 4) float64, world → camera [R | t]
    intrinsic: torch.Tensor  # (3, 3) float64
    height: int
    width: int
    light_directional: torch.Tensor  # (3,)
    light_ambient: float
    background: torch.Tensor  # (3,)
    target: torch.Tensor  # (H, W, 3)
    sigma: float


def _octahedron():
    vertices = np.array([[1.0, 0, 0], [-1.0, 0, 0], [0, 1.0, 0], [0, -1.0, 0], [0, 0, 1.0], [0, 0, -1.0]])
    faces = []
    for x, y, z in [(0, 2, 4), (2, 1, 4), (1, 3, 4), (3, 0, 4), (2, 0, 5), (1, 2, 5), (3, 1, 5), (0, 3, 5)]:
        if np.dot(vertices[x], np.cross(vertices[y], vertices[z])) < 0:
            y, z = z, y
        faces.append([x, y, z])
    return np.array(faces, dtype=np.int64), vertices


def _loop_subdivide(faces: np.ndarray, vertices: np.ndarray):
    """One Loop subdivision of a closed mesh: edge points 3/8·ends +
    1/8·opposite corners, old vertices 5/8·self + 3/8·mean of their
    neighbours; each face becomes its three corner faces and its middle
    face."""
    nv, nf = len(vertices), len(faces)
    half = np.vstack((faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]))
    keys = np.maximum(half[:, 0], half[:, 1]) + np.minimum(half[:, 0], half[:, 1]) * nv
    uniq, edge_id = np.unique(keys, return_inverse=True)
    edge_id = edge_id.reshape(-1)
    ne = len(uniq)
    edges = np.stack([uniq % nv, uniq // nv], axis=1)
    face_sums = vertices[faces].sum(axis=1)[np.tile(np.arange(nf), 3)]
    face_part = np.stack([np.bincount(edge_id, face_sums[:, k], minlength=ne) for k in range(3)], axis=1)
    mid = face_part / 8 + vertices[edges].sum(axis=1) / 8
    ends = np.concatenate([edges[:, 0], edges[:, 1]])
    others = np.concatenate([edges[:, 1], edges[:, 0]])
    neighbour_sum = np.stack([np.bincount(ends, vertices[others, k], minlength=nv) for k in range(3)], axis=1)
    degree = np.bincount(ends, minlength=nv)
    moved = (3 / 8) * neighbour_sum / degree[:, None] + (5 / 8) * vertices
    fe = edge_id.reshape(3, nf).T + nv  # edge points of (v0, v1), (v1, v2), (v2, v0)
    new_faces = np.vstack([
        np.stack([faces[:, 0], fe[:, 0], fe[:, 2]], axis=1),
        np.stack([faces[:, 1], fe[:, 1], fe[:, 0]], axis=1),
        np.stack([faces[:, 2], fe[:, 2], fe[:, 1]], axis=1),
        fe,
    ])
    return new_faces, np.concatenate([moved, mid])


def octahedron_sphere(subdivisions: int):
    """(faces (F, 3) int64, vertices (V, 3) float64): the octahedron
    subdivided ``subdivisions`` times, its vertices on the unit sphere,
    wound counter-clockwise seen from outside (8·4^n faces)."""
    faces, vertices = _octahedron()
    for _ in range(subdivisions):
        faces, vertices = _loop_subdivide(faces, vertices)
    return faces, vertices / np.linalg.norm(vertices, axis=1, keepdims=True)


def random_rotation(rng: np.random.Generator) -> np.ndarray:
    """A rotation matrix drawn uniformly (QR of a Gaussian matrix)."""
    q, r = np.linalg.qr(rng.standard_normal((3, 3)))
    q = q * np.sign(np.diag(r))
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    return q


def framing_camera(width: int, height: int, fov: float, vertices: np.ndarray, rot: np.ndarray):
    """(extrinsic (3, 4), intrinsic (3, 3)) of a pinhole camera with
    rotation ``rot`` placed so that the mesh's bounding box fills the
    image, as ``default_camera`` of the repository's size sweep frames it."""
    cam_vertices = vertices.dot(rot.T)
    box_min, box_max = cam_vertices.min(axis=0), cam_vertices.max(axis=0)
    box_center, box_size = 0.5 * (box_max + box_min), box_max - box_min
    tan_half = np.tan(0.5 * fov * np.pi / 180)
    distance = max(0.5 * box_size[0] / tan_half + 0.5 * box_size[2],
                   0.5 * box_size[1] * (width / height) / tan_half + 0.5 * box_size[2])
    center = rot.T.dot(box_center + np.array([0, 0, -distance]))
    focal = 0.5 * width / tan_half
    intrinsic = np.array([[focal, 0, width / 2], [0, focal, height / 2], [0, 0, 1]])
    return np.column_stack((rot, -rot.dot(center))), intrinsic


def project(vertices: np.ndarray, extrinsic: np.ndarray, intrinsic: np.ndarray) -> np.ndarray:
    """Pixel coordinates (x = column, y = row) of world points."""
    p = vertices.dot(extrinsic[:, :3].T) + extrinsic[:, 3]
    return (p[:, :2] / p[:, 2:3]).dot(intrinsic[:2, :2].T) + intrinsic[:2, 2]


def target_image(traffic: dict, ij: np.ndarray, background, height: int, width: int, device) -> torch.Tensor:
    """(H, W, 3) float64: the background, and over it a disc near the
    mesh's silhouette (centre shifted and radius scaled by the traffic's
    fractions) filled with the traffic's linear colour ramp."""
    t = traffic["target"]
    lo, hi = ij.min(axis=0), ij.max(axis=0)
    r0 = 0.25 * ((hi - lo).sum())
    cx, cy = 0.5 * (lo + hi) + np.asarray(t["centre_shift"], dtype=np.float64) * r0
    r = r0 * float(t["radius_scale"])
    c0, gx, gy = (np.asarray(t[k], dtype=np.float64) for k in ("color", "ramp_x", "ramp_y"))
    x = torch.arange(width, dtype=torch.float64, device=device)[None, :, None]
    y = torch.arange(height, dtype=torch.float64, device=device)[:, None, None]
    f64 = dict(dtype=torch.float64, device=device)
    ramp = (torch.tensor(c0, **f64) + torch.tensor(gx, **f64) * (x - cx) / r
            + torch.tensor(gy, **f64) * (y - cy) / r).clamp(0.0, 1.0)
    inside = (x - cx) ** 2 + (y - cy) ** 2 < r * r
    return torch.where(inside, ramp, torch.tensor(background, **f64))


def learning_rates(traffic: dict, vertices: torch.Tensor) -> dict:
    """Adam's rate of each leaf: the vertices' is ``lr_vertices_per_extent``
    times the mesh's extent (the largest side of its bounding box), as the
    port's own mesh fits set it; the colours' is ``lr_colors``."""
    extent = float((vertices.amax(dim=0) - vertices.amin(dim=0)).max())
    return {"vertices": float(traffic["lr_vertices_per_extent"]) * extent, "colors": float(traffic["lr_colors"])}


DTYPES = {"float64": torch.float64, "float32": torch.float32}
# the size sweep's camera: looking down the world's z axis, image rows along −y
CAMERA_ROTATION = np.array([[1.0, 0, 0], [0, -1, 0], [0, 0, -1]])


def make_inputs(config: dict, traffic: dict, seed: int, device) -> Inputs:
    """The inputs of one fit of ``config`` under ``traffic`` for ``seed``,
    on ``device`` in the configuration's dtype."""
    dtype = DTYPES[config["dtype"]]
    rng = np.random.default_rng(int(seed) % (1 << 64))
    if config["mesh"] != "octahedron_sphere":
        raise ValueError(f"unknown mesh {config['mesh']!r}")
    faces, vertices = octahedron_sphere(int(config["subdivisions"]))
    # the configuration's fixed turn of the mesh: on the symmetric sphere the light (−0.4, −0.4, −0.8)
    # is exactly orthogonal to some vertex normals, where the shading's gradient depends on the last
    # bit; the same turn for every seed, since the geometry sets the plan and so the work
    vertices = vertices.dot(random_rotation(np.random.default_rng(int(config["mesh_rotation_seed"]))).T)
    height, width = int(config["height"]), int(config["width"])
    extrinsic, intrinsic = framing_camera(width, height, float(config["fov_degrees"]), vertices, CAMERA_ROTATION)
    lo, hi = traffic["color_range"]
    colors = rng.uniform(lo, hi, (len(vertices), 3))
    background = np.asarray(config["background_color"], dtype=np.float64)
    target = target_image(traffic, project(vertices, extrinsic, intrinsic), background, height, width, device)

    def cast(a):
        return torch.as_tensor(a, dtype=torch.float64, device=device).to(dtype)

    return Inputs(
        faces=torch.as_tensor(faces, dtype=torch.int64, device=device), vertices=cast(vertices), colors=cast(colors),
        extrinsic=torch.as_tensor(extrinsic, dtype=torch.float64, device=device),
        intrinsic=torch.as_tensor(intrinsic, dtype=torch.float64, device=device), height=height, width=width,
        light_directional=cast(config["light_directional"]), light_ambient=float(config["light_ambient"]),
        background=cast(background), target=target.to(dtype), sigma=float(traffic["sigma"]),
    )
