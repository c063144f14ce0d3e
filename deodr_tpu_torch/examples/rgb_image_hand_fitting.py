"""Fit a colored hand mesh to an RGB image.

Counterpart of ``examples/rgb_image_hand_fitting.py``: the same data,
distortion, inits and defaults, on the port's fitter.
``python -m deodr_tpu_torch.examples.rgb_image_hand_fitting`` runs 50
iterations on the card in float64; ``--device``, ``--dtype``,
``--max-iter`` and ``--n-subdivision`` change that.
"""

from __future__ import annotations

import argparse
import os
from typing import List

import numpy as np
import torch

from deodr_tpu_torch import data_path
from deodr_tpu_torch.examples.depth_image_hand_fitting import _dtype
from deodr_tpu_torch.geometry.mesh import ColoredTriMesh
from deodr_tpu_torch.io.obj import read_obj
from deodr_tpu_torch.io.png import read_png
from deodr_tpu_torch.mesh_fitter import MeshRGBFitterWithPose


def make_fitter(n_subdivision: int = 0, device=None, dtype: torch.dtype = torch.float64) -> MeshRGBFitterWithPose:
    """The RGB fitter of the example (image 200 wide × 199 high), its image set."""
    hand_image = read_png(os.path.join(data_path, "hand.png")).astype(np.double) / 255
    if hand_image.ndim == 3 and hand_image.shape[2] == 4:
        hand_image = hand_image[:, :, :3]

    faces, vertices = read_obj(os.path.join(data_path, "hand.obj"))
    mesh = ColoredTriMesh(faces.copy(), vertices=vertices, nb_colors=3).subdivise(n_subdivision)
    vertices = mesh.vertices.cpu().numpy()
    translation_init = np.mean(vertices, axis=0)
    fitter = MeshRGBFitterWithPose(
        vertices - translation_init[None, :],
        mesh.faces,
        default_color=np.array([0.4, 0.3, 0.25]),
        default_light_directional=-np.array([0.1, 0.5, 0.4]),
        default_light_ambient=0.6,
        update_lights=True,
        update_color=True,
        euler_init=np.array([0, 0, 0]),
        translation_init=translation_init,
        cregu=1000,
        device=device,
        dtype=dtype,
    )
    fitter.reset()
    fitter.set_image(hand_image, distortion=np.array([-1, 0, 0, 0, 0]))
    fitter.set_background_color(np.array([0.5, 0.6, 0.7]))
    return fitter


def run(max_iter: int = 100, n_subdivision: int = 0, device=None, dtype: torch.dtype = torch.float64) -> List[float]:
    """The energies of ``max_iter`` steps of the RGB fit."""
    fitter = make_fitter(n_subdivision, device, dtype)
    return [fitter.step()[0] for _ in range(max_iter)]


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None, help="torch device (default cuda)")
    parser.add_argument("--dtype", default="float64", choices=("float32", "float64"))
    parser.add_argument("--max-iter", type=int, default=50)
    parser.add_argument("--n-subdivision", type=int, default=0)
    args = parser.parse_args()
    energies = run(args.max_iter, args.n_subdivision, args.device, _dtype(args.dtype))
    print(f"energy[{len(energies) - 1}] =", energies[-1])
