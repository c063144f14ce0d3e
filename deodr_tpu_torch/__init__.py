"""deodr_tpu_torch: the PyTorch / CUDA port of deodr_tpu.

A differentiable triangle-mesh rasterizer (discontinuity-edge-overdraw
antialiasing) on an NVIDIA GPU: ``render_scene`` and its autograd
gradients with respect to vertex positions and colors, with the per-pixel
loops of the tiled solid and edge passes in hand-written CUDA kernels
(``csrc/``). Entry points run where the scene's tensors live; scenes are
made on ``cuda`` unless the caller asks for the CPU, where every kernel
runs its plain PyTorch version.

Float32 products must not run in TF32, which keeps about three decimal
digits: the package states PyTorch's TF32 switches off.
"""

import torch

from deodr_tpu_torch.ops.render import SceneBuffers, render_scene, scene_buffers_from_numpy
from deodr_tpu_torch.ops.tiled import TilingConfig, suggest_tiling

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__all__ = ["SceneBuffers", "TilingConfig", "render_scene", "scene_buffers_from_numpy", "suggest_tiling"]
