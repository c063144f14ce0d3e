"""deodr_tpu_torch: the PyTorch / CUDA port of deodr_tpu.

A differentiable triangle-mesh rasterizer (discontinuity-edge-overdraw
antialiasing) on an NVIDIA GPU: ``render_scene`` and its autograd
gradients with respect to vertex positions, colors, texture coordinates,
shade and texture, tiled (the per-pixel loops of the solid and edge passes
in hand-written CUDA kernels, ``csrc/``) or untiled. Entry points run where the scene's tensors live; scenes are
made on ``cuda`` unless the caller asks for the CPU, where every kernel
runs its plain PyTorch version. The package sets none of PyTorch's global
switches.
"""

from deodr_tpu_torch.ops.render import SceneBuffers, render_scene, scene_buffers_from_numpy, validate_capacities
from deodr_tpu_torch.ops.tiled import EdgeTexPlan, TilingConfig, suggest_tiling

__all__ = ["EdgeTexPlan", "SceneBuffers", "TilingConfig", "render_scene", "scene_buffers_from_numpy", "suggest_tiling",
           "validate_capacities"]
