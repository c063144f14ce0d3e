"""Fit a hand mesh to three RGB views with a pose per view.

Counterpart of ``examples/rgb_multiview_hand.py``: the same data, inits
and defaults, on the port's multi-frame fitter (the views in sequence on
one device). The views are JPEG files, read with PIL.
``python -m deodr_tpu_torch.examples.rgb_multiview_hand`` runs 30
iterations on the card in float64; ``--device``, ``--dtype`` and
``--max-iter`` change that.
"""

from __future__ import annotations

import argparse
import glob
import os
from typing import List

import numpy as np
import torch

from deodr_tpu_torch import data_path
from deodr_tpu_torch.examples.depth_image_hand_fitting import _dtype
from deodr_tpu_torch.io.obj import read_obj
from deodr_tpu_torch.mesh_fitter import MeshRGBFitterWithPoseMultiFrame


def load_views() -> List[np.ndarray]:
    """The three views (283 high × 200 wide) in [0, 1]."""
    import PIL.Image

    return [np.asarray(PIL.Image.open(f)).astype(np.double) / 255
            for f in sorted(glob.glob(os.path.join(data_path, "hand_multiview", "*.jpg")))]


def make_fitter(device=None, dtype: torch.dtype = torch.float64) -> MeshRGBFitterWithPoseMultiFrame:
    """The multi-frame fitter of the example, its images set."""
    hand_images = load_views()
    nb_frames = len(hand_images)
    faces, vertices = read_obj(os.path.join(data_path, "hand.obj"))
    euler_init = np.vstack([np.array([0, yrot, 0]) for yrot in np.linspace(-0.5, 0.5, nb_frames)])
    vertices = vertices - np.mean(vertices, axis=0)
    t_init = np.array([0, -0.2, 0.2])
    fitter = MeshRGBFitterWithPoseMultiFrame(
        vertices,
        faces,
        default_color=np.array([0.4, 0.3, 0.25]) * 1.5,
        default_light_directional=-np.array([0.1, 0.5, 0.4]),
        default_light_ambient=0.6,
        euler_init=euler_init,
        translation_init=np.tile(t_init[None, :], [nb_frames, 1]),
        cregu=2000,
        device=device,
        dtype=dtype,
    )
    fitter.reset()
    fitter.set_images(hand_images)
    fitter.set_background_color(np.array([0, 0, 0]))
    return fitter


def run(max_iter: int = 300, device=None, dtype: torch.dtype = torch.float64) -> List[float]:
    """The energies of ``max_iter`` steps of the multi-view fit."""
    fitter = make_fitter(device, dtype)
    return [fitter.step()[0] for _ in range(max_iter)]


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None, help="torch device (default cuda)")
    parser.add_argument("--dtype", default="float64", choices=("float32", "float64"))
    parser.add_argument("--max-iter", type=int, default=30)
    args = parser.parse_args()
    energies = run(args.max_iter, args.device, _dtype(args.dtype))
    print(f"energy[{len(energies) - 1}] =", energies[-1])
