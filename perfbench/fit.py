"""The system under test: one Adam fit of a mesh to a target image through
``deodr_tpu_torch.interop.Scene3DTorch``, written as a user writes it.

A step renders the current vertices and vertex colours, takes the squared
error to the target, back-propagates and steps Adam. Each render runs the
port's planner (with its host read) and its kernels; a step that changes
the plan re-plans inside the step.
"""

from __future__ import annotations

import torch
from torch.profiler import record_function

from deodr_tpu_torch.geometry.mesh import ColoredTriMesh
from deodr_tpu_torch.interop import CameraTorch, Scene3DTorch

from perfbench.inputs import Inputs, learning_rates

LEAVES = ("vertices", "colors")


class Fit:
    """The fit's scene, camera, parameters and optimizer, built once and
    driven by :meth:`step`."""

    def __init__(self, inputs: Inputs, traffic: dict, device):
        mesh = ColoredTriMesh(inputs.faces.cpu().numpy(), inputs.vertices.cpu(), colors=inputs.colors.cpu())
        self.scene = Scene3DTorch(sigma=inputs.sigma, device=device)
        self.scene.set_mesh(mesh)
        self.scene.set_background_color(inputs.background.double().cpu().numpy())
        self.camera = CameraTorch(inputs.extrinsic.cpu().numpy(), inputs.intrinsic.cpu().numpy(), inputs.height,
                                  inputs.width)
        self.params = {"vertices": inputs.vertices.clone().requires_grad_(True),
                       "colors": inputs.colors.clone().requires_grad_(True)}
        self.light_directional = inputs.light_directional
        self.light_ambient = inputs.light_ambient
        self.target = inputs.target
        lrs = learning_rates(traffic, inputs.vertices)
        self.optimizer = torch.optim.Adam(
            [{"params": [self.params[name]], "lr": lrs[name]} for name in LEAVES],
            betas=tuple(traffic["betas"]), eps=float(traffic["eps"]),
        )

    def render(self) -> torch.Tensor:
        return self.scene.render(self.camera, self.params["vertices"], self.params["colors"], self.light_directional,
                                 self.light_ambient)

    def loss(self, image: torch.Tensor) -> torch.Tensor:
        return ((image - self.target) ** 2).sum()

    def step(self) -> torch.Tensor:
        """One step; returns its loss (on the device, not read)."""
        self.optimizer.zero_grad(set_to_none=True)
        with record_function("perfbench.render"):
            image = self.render()
        with record_function("perfbench.loss"):
            loss = self.loss(image)
        with record_function("perfbench.backward"):
            loss.backward()
        with record_function("perfbench.adam"):
            self.optimizer.step()
        return loss.detach()

    def gradients(self) -> dict:
        """Each leaf's gradient as Adam received it in the last step (zero
        where it received none)."""
        return {name: p.grad.clone() if p.grad is not None else torch.zeros_like(p)
                for name, p in self.params.items()}

    def values(self) -> dict:
        return {name: p.detach().clone() for name, p in self.params.items()}
