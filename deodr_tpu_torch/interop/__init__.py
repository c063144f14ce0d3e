"""The torch class surface: ``render_scene_torch``, ``CameraTorch`` and
``Scene3DTorch``, the counterparts of ``deodr_tpu.interop``. In the JAX
package they bridge torch to the JAX renderer; here they run on the port's
own renderer, which torch autograd differentiates directly."""

from deodr_tpu_torch.interop.torch_bridge import render_scene_torch
from deodr_tpu_torch.interop.torch_scene import CameraTorch, Scene3DTorch

__all__ = ["render_scene_torch", "CameraTorch", "Scene3DTorch"]
