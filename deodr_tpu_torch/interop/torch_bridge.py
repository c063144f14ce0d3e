"""``render_scene_torch``: a 2.5D scene rendered as a differentiable torch
operation.

Counterpart of ``deodr_tpu/interop/torch_bridge.py``, with its signature
and its result. There it is a ``torch.autograd.Function`` that copies the
tensors to the host, renders with JAX and runs ``jax.vjp`` backward. The
port's :func:`deodr_tpu_torch.render_scene` is differentiable by torch
autograd already (through the kernels' own autograd functions), so here
the tensors are put into the scene's buffers and rendered where they lie;
the gradients land on the inputs' own devices. Gradients flow to ij,
colors, uv, shade and texture.
"""

from __future__ import annotations

import dataclasses

from deodr_tpu_torch.ops.render import SceneBuffers, render_scene
from deodr_tpu_torch.scene import plan_tiling


def render_scene_torch(scene_buffers: SceneBuffers, sigma: float, ij, colors, uv, shade, texture,
                       aa_edge_capacity=None):
    """The image (H, W, C) of ``scene_buffers`` with its differentiable
    fields replaced by the tensors ``ij`` and ``colors`` (and ``uv``,
    ``shade`` and ``texture`` where they are not None), differentiable with
    respect to each of them.

    The route is the port's scenes' (:func:`deodr_tpu_torch.scene.plan_tiling`):
    untiled up to 256 faces, above that the tiled kernel route (whose plan
    reads ij, faces and edgeflags to the host once).
    """
    buffers = dataclasses.replace(
        scene_buffers,
        ij=ij,
        colors=colors,
        uv=scene_buffers.uv if uv is None else uv,
        shade=scene_buffers.shade if shade is None else shade,
        texture=scene_buffers.texture if texture is None else texture,
    )
    tiling = plan_tiling(buffers.ij, buffers.faces, buffers.edgeflags, buffers.height, buffers.width, sigma,
                         buffers.integer_pixel_centers)
    image, _, _ = render_scene(buffers, float(sigma), aa_edge_capacity=aa_edge_capacity, tiling=tiling)
    return image
