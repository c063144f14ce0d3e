"""Fit a hand mesh to a depth image.

Counterpart of ``examples/depth_image_hand_fitting.py``: the same data,
crop, focal, distortion, inits and defaults, on the port's fitters.
``python -m deodr_tpu_torch.examples.depth_image_hand_fitting`` runs 50
iterations on the card in float64; ``--device cpu``, ``--dtype float32``,
``--max-iter``, ``--optimizer lbfgs`` and ``--n-subdivision`` change that.
"""

from __future__ import annotations

import argparse
import os
from typing import List

import numpy as np
import torch

from deodr_tpu_torch import data_path
from deodr_tpu_torch.geometry.mesh import ColoredTriMesh
from deodr_tpu_torch.io.obj import read_obj
from deodr_tpu_torch.mesh_fitter import MeshDepthFitter, MeshDepthFitterEnergy

MAX_DEPTH = 450


def load_depth_image() -> np.ndarray:
    """The hand's depth image (200 × 200, cropped from 240 × 320 and
    mirrored), 0 replaced by the far plane, scaled to [0, 1]."""
    depth_image = np.fliplr(
        np.fromfile(os.path.join(data_path, "depth.bin"), dtype=np.float32).reshape(240, 320).astype(np.float64)
    )
    depth_image = depth_image[20:-20, 60:-60]
    depth_image[depth_image == 0] = MAX_DEPTH
    return depth_image / MAX_DEPTH


def make_fitter(n_subdivision: int = 0, optimizer: str = "heavyball", device=None,
                dtype: torch.dtype = torch.float64):
    """The depth fitter of the example, its image set."""
    faces, vertices = read_obj(os.path.join(data_path, "hand.obj"))
    mesh = ColoredTriMesh(faces.copy(), vertices=vertices, nb_colors=0).subdivise(n_subdivision)
    euler_init = np.array([0.1, 0.1, 0.1])
    translation_init = np.zeros(3)
    # "heavyball" = the reference's update rule; "lbfgs" = the energy module with torch.optim.LBFGS
    fitter_cls = {"heavyball": MeshDepthFitter, "lbfgs": MeshDepthFitterEnergy}[optimizer]
    fitter = fitter_cls(mesh.vertices.cpu().numpy(), mesh.faces, euler_init, translation_init, cregu=1000,
                        device=device, dtype=dtype)
    fitter.set_image(load_depth_image(), focal=241, distortion=np.array([1, 0, 0, 0, 0]))
    fitter.set_max_depth(1)
    fitter.set_depth_scale(110 / MAX_DEPTH)
    return fitter


def run(max_iter: int = 300, n_subdivision: int = 0, optimizer: str = "heavyball", device=None,
        dtype: torch.dtype = torch.float64) -> List[float]:
    """The energies of ``max_iter`` steps of the depth fit."""
    fitter = make_fitter(n_subdivision, optimizer, device, dtype)
    energies: List[float] = []
    for _ in range(max_iter):
        out = fitter.step()
        energies.append(out[0] if isinstance(out, tuple) else out)
    return energies


def _dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "float64": torch.float64}[name]


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None, help="torch device (default cuda)")
    parser.add_argument("--dtype", default="float64", choices=("float32", "float64"))
    parser.add_argument("--max-iter", type=int, default=50)
    parser.add_argument("--n-subdivision", type=int, default=0)
    parser.add_argument("--optimizer", default="heavyball", choices=("heavyball", "lbfgs"))
    args = parser.parse_args()
    energies = run(args.max_iter, args.n_subdivision, args.optimizer, args.device, _dtype(args.dtype))
    print(f"energy[{len(energies) - 1}] =", energies[-1])
