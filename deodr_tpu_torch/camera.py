"""Pinhole camera with OpenCV-convention intrinsics and 5-parameter
distortion.

PyTorch counterpart of ``deodr_tpu/camera.py``: the camera's matrices are
numpy (static), ``project_points`` is plain torch on the points' device and
differentiable by autograd.
"""

from __future__ import annotations

from typing import Iterable, Optional, Union

import numpy as np
import torch


def project_points_arrays(extrinsic, intrinsic, distortion, points_3d):
    """World points (N, 3) → distorted pixel coordinates (N, 2) (x = column,
    y = row) and depths (N,).

    extrinsic (3, 4), intrinsic (3, 3) and distortion (None or (5,):
    k1, k2, p1, p2, k3) are tensors of the points' dtype and device. The two
    matrix products are written as a broadcast multiply and a sum, so they
    run in the points' own precision whatever PyTorch's TF32 switches say.
    """
    r = extrinsic[:3, :3]
    t = extrinsic[:3, 3]
    p_camera = (points_3d[:, None, :] * r).sum(-1) + t
    depths = p_camera[:, 2]
    projected = p_camera[:, :2] / depths[:, None]
    if distortion is not None:
        k1, k2, p1, p2, k3 = (distortion[i] for i in range(5))
        x = projected[:, 0]
        y = projected[:, 1]
        x2 = x**2
        y2 = y**2
        r2 = x2 + y2
        radial = 1 + k1 * r2 + k2 * r2**2 + k3 * r2**3
        tang_x = 2 * p1 * x * y + p2 * (r2 + 2 * x2)
        tang_y = p1 * (r2 + 2 * y2) + 2 * p2 * x * y
        projected = torch.stack((x * radial + tang_x, y * radial + tang_y), dim=1)
    ij = (projected[:, None, :] * intrinsic[:2, :2]).sum(-1) + intrinsic[:2, 2]
    return ij, depths


class Camera:
    """extrinsic: (3, 4) [R|t] world→camera; intrinsic: (3, 3)
    upper-triangular; distortion: None or (k1, k2, p1, p2, k3) as in
    OpenCV."""

    def __init__(
        self,
        extrinsic,
        intrinsic,
        height: int,
        width: int,
        distortion: Union[None, Iterable[float], np.ndarray] = None,
        checks: bool = True,
        tol: float = 1e-6,
    ):
        extrinsic = np.asarray(extrinsic, dtype=np.float64)
        intrinsic = np.asarray(intrinsic, dtype=np.float64)
        if distortion is not None:
            distortion = np.asarray(distortion, dtype=np.float64)
        if checks:
            if extrinsic.shape != (3, 4) or intrinsic.shape != (3, 3):
                raise ValueError("extrinsic must be (3, 4) and intrinsic (3, 3)")
            if not np.all(intrinsic[2, :] == [0, 0, 1]):
                raise ValueError("the last row of intrinsic must be [0, 0, 1]")
            if np.linalg.norm(extrinsic[:3, :3].T.dot(extrinsic[:3, :3]) - np.eye(3)) >= tol:
                raise ValueError("the rotation part of extrinsic is not orthonormal")
            if distortion is not None and distortion.shape != (5,):
                raise ValueError("distortion must have 5 parameters")
        self.extrinsic = extrinsic
        self.intrinsic = intrinsic
        self.distortion = distortion
        self.height = int(height)
        self.width = int(width)

    def project_points(self, points_3d: torch.Tensor, return_depths: bool = True):
        """World → distorted pixel coordinates (x = column, y = row), and
        depths, on the device and in the dtype of ``points_3d``."""
        def like(a):
            return None if a is None else torch.as_tensor(a, dtype=points_3d.dtype, device=points_3d.device)

        ij, depths = project_points_arrays(like(self.extrinsic), like(self.intrinsic), like(self.distortion), points_3d)
        return (ij, depths) if return_depths else ij

    def get_center(self) -> np.ndarray:
        return -self.extrinsic[:3, :3].T.dot(self.extrinsic[:, 3])


class PerspectiveCamera(Camera):
    """Camera from field of view (degrees), center and rotation."""

    def __init__(self, width: int, height: int, fov: float, camera_center, rot: Optional[np.ndarray] = None,
                 distortion=None):
        camera_center = np.asarray(camera_center)
        if camera_center.shape != (3,):
            raise ValueError("camera_center must have 3 coordinates")
        if rot is None:
            rot = np.eye(3)
        else:
            rot = np.asarray(rot)
            if rot.shape != (3, 3) or not np.allclose(rot.T.dot(rot), np.eye(3), atol=1e-6) or np.linalg.det(rot) <= 0:
                raise ValueError("rot must be a 3×3 rotation matrix")
        focal = 0.5 * width / np.tan(0.5 * fov * np.pi / 180)
        trans = -rot.T.dot(camera_center)
        intrinsic = np.array([[focal, 0, width / 2], [0, focal, height / 2], [0, 0, 1]])
        extrinsic = np.column_stack((rot, trans))
        super().__init__(extrinsic=extrinsic, intrinsic=intrinsic, distortion=distortion, width=width, height=height)


def default_camera(width, height, fov, vertices, rot, distortion=None) -> Camera:
    """Auto-frame a camera so that the mesh fills most of the image."""
    vertices = np.asarray(vertices)
    cam_vertices = vertices.dot(np.asarray(rot).T)
    box_min = cam_vertices.min(axis=0)
    box_max = cam_vertices.max(axis=0)
    box_center = 0.5 * (box_max + box_min)
    box_size = box_max - box_min
    tan_half = np.tan(0.5 * fov * np.pi / 180)
    camera_distance_x = 0.5 * box_size[0] / tan_half + 0.5 * box_size[2]
    camera_distance_y = 0.5 * box_size[1] * (width / height) / tan_half + 0.5 * box_size[2]
    camera_distance = max(camera_distance_x, camera_distance_y)
    camera_center = np.asarray(rot).T.dot(box_center + np.array([0, 0, -camera_distance]))
    return PerspectiveCamera(width, height, fov, camera_center, rot, distortion)
