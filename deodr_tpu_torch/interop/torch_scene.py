"""``CameraTorch`` and ``Scene3DTorch``: a 3D scene rendered from torch
tensors that the caller owns.

Counterpart of ``deodr_tpu/interop/torch_scene.py`` (the reference's
``deodr/pytorch/differentiable_renderer_pytorch.py:13-109``). The caller
passes the vertices, colours, lights, uv and texture of each render as
tensors and differentiates the returned image with torch autograd. The
chain is the port's ``Scene3D``'s: the camera projection of
:mod:`deodr_tpu_torch.camera`, the vertex normals of
:mod:`deodr_tpu_torch.geometry.adjacency` (a degenerate face's normal is
zero), the silhouette flags on the device, and the plan of
``Scene3D._eager_plan`` measured on the vertices passed to the render.
As in ``deodr_tpu``'s ``Scene3DTorch``, the normals ignore
``mesh.clockwise``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from deodr_tpu_torch.camera import project_points_arrays
from deodr_tpu_torch.scene import Scene3D


class CameraTorch:
    """OpenCV-convention pinhole camera on float64 torch tensors
    (``extrinsic`` (3, 4), ``intrinsic`` (3, 3), ``distortion`` None or
    (k1, k2, p1, p2, k3)); a projection runs on the points' device and in
    their dtype."""

    def __init__(self, extrinsic, intrinsic, height: int, width: int, distortion=None):
        self.extrinsic = torch.as_tensor(np.asarray(extrinsic), dtype=torch.float64)
        self.intrinsic = torch.as_tensor(np.asarray(intrinsic), dtype=torch.float64)
        self.distortion = (
            None if distortion is None else torch.as_tensor(np.asarray(distortion), dtype=torch.float64)
        )
        self.height = int(height)
        self.width = int(width)
        assert tuple(self.extrinsic.shape) == (3, 4)
        assert tuple(self.intrinsic.shape) == (3, 3)

    @classmethod
    def from_camera(cls, camera) -> "CameraTorch":
        """From a :class:`deodr_tpu_torch.camera.Camera`."""
        return cls(camera.extrinsic, camera.intrinsic, camera.height, camera.width, camera.distortion)

    def project_points(self, points_3d: torch.Tensor):
        """World points (V, 3) → (ij (V, 2), depths (V,)), differentiable
        with respect to the points
        (:func:`deodr_tpu_torch.camera.project_points_arrays`)."""
        def like(t):
            return None if t is None else t.to(device=points_3d.device, dtype=points_3d.dtype)

        return project_points_arrays(like(self.extrinsic), like(self.intrinsic), like(self.distortion), points_3d)


class Scene3DTorch:
    """A mesh and a background colour, rendered from the tensors passed to
    :meth:`render`.

    ``device`` (default ``cuda``; asking for CUDA where there is none
    raises) is where every render runs; ``impl`` is ``Scene3D``'s:
    ``"kernel"`` runs the CUDA kernels on a CUDA device (a CPU device takes
    their plain versions), ``"reference"`` the plain versions anywhere.
    """

    def __init__(self, sigma: float = 1.0, device=None, impl: str = "kernel"):
        self._scene = Scene3D(sigma=float(sigma), device=device, impl=impl)
        # with its index ("cuda" is the current card), as tensors report their device
        self.device = torch.empty(0, device=self._scene.device).device

    @property
    def sigma(self) -> float:
        return self._scene.sigma

    @sigma.setter
    def sigma(self, sigma: float) -> None:
        self._scene.sigma = float(sigma)

    @property
    def mesh(self):
        return self._scene.mesh

    @property
    def background_color(self) -> Optional[np.ndarray]:
        return self._scene.background_color

    def set_mesh(self, mesh) -> None:
        self._scene.set_mesh(mesh)

    def set_background_color(self, color) -> None:
        self._scene.set_background_color(color)

    def render(
        self,
        camera: CameraTorch,
        vertices: torch.Tensor,
        vertices_colors: Optional[torch.Tensor] = None,
        light_directional: Optional[torch.Tensor] = None,
        light_ambient=0.0,
        uv: Optional[torch.Tensor] = None,
        texture: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """The image (H, W, C), differentiable with respect to every tensor
        argument. Pass either ``vertices_colors`` (V, C), or ``uv`` (Vuv, 2)
        and ``texture`` (th, tw, C). Lambertian shading: max(0, −⟨n, l⟩) +
        ambient per vertex; backface culling, strict edges, integer pixel
        centres. Every tensor must lie on the scene's device."""
        assert self.mesh is not None, "call set_mesh first"
        assert self.background_color is not None, "call set_background_color first"
        args = dict(vertices=vertices, vertices_colors=vertices_colors, light_directional=light_directional,
                    light_ambient=light_ambient, uv=uv, texture=texture)
        for name, t in args.items():
            if torch.is_tensor(t) and t.device != self.device:
                raise ValueError(f"{name} is on {t.device}, the scene renders on {self.device}")
        textured = uv is not None
        if textured:
            assert texture is not None
        else:
            assert vertices_colors is not None
        if not torch.is_tensor(light_ambient):
            light_ambient = torch.tensor(float(light_ambient), dtype=vertices.dtype, device=self.device)
        if light_directional is not None and self.mesh.clockwise:
            # the normals here ignore mesh.clockwise, as in deodr_tpu's Scene3DTorch, where
            # Scene3D's flip them: a clockwise mesh is lit as from the opposite light
            light_directional = -light_directional
        inputs = (vertices, None if textured else vertices_colors, light_directional, light_ambient,
                  uv, texture if textured else None)
        image, _ = self._scene._render_inputs(camera, inputs, backface_culling=True)
        return image
