"""Fit the depth hand scene with Adam.

Counterpart of ``examples/optax_fitting.py``, whose name it keeps: the same
energy (the clipped depth render's squared difference to the depth image
plus the rigid energy, ``cregu`` = 1000, on ``data/hand.obj`` with the
depth fit's camera, focal 241 and k1 = 1) minimized over the vertices, the
quaternion and the translation by ``torch.optim.Adam`` with optax's
``adam`` defaults (β = 0.9 / 0.999, ε = 1e-8 added outside the square
root), so that the two trajectories agree step for step. A step renders
with the depth fitter's plan (on ``cuda`` the kernels B1 and B2) and reads
the host once: the energy and the plan statistics in one transfer.

``python -m deodr_tpu_torch.examples.optax_fitting [--device cpu]`` runs
60 iterations.
"""

from __future__ import annotations

import argparse
from typing import List

import torch

from deodr_tpu_torch.examples import depth_image_hand_fitting as depth_ex
from deodr_tpu_torch.geometry.transforms import normalize, qrot


def run(max_iter: int = 100, learning_rate: float = 5e-4, device=None) -> List[float]:
    """The energies of ``max_iter`` Adam steps, in float64."""
    fitter = depth_ex.make_fitter(device=device)
    params = [torch.nn.Parameter(fitter._tensor(a)) for a in
              (fitter.vertices, fitter.transform_quaternion, fitter.transform_translation)]
    vertices, quaternion, translation = params
    opt = torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)

    def energy_and_grads(cap, tiling):
        opt.zero_grad()
        e_data = fitter._data_energy(vertices, quaternion, translation, cap, tiling)[0]
        energy = e_data + fitter.rigid_energy.evaluate(vertices)[0]
        energy.backward()
        return None, [energy]

    energies: List[float] = []
    for _ in range(max_iter):
        with torch.no_grad():
            vt = qrot(normalize(quaternion), vertices) + translation
        _, (energy,) = fitter.core.planned_step(fitter.camera, vt[None], energy_and_grads,
                                                lambda: [fitter._buffers(vertices, quaternion, translation)])
        opt.step()
        energies.append(energy)
    return energies


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None, help="torch device (default cuda)")
    parser.add_argument("--max-iter", type=int, default=60)
    args = parser.parse_args()
    energies = run(max_iter=args.max_iter, device=args.device)
    print("energy[0] =", energies[0], " energy[-1] =", energies[-1])
