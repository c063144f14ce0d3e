"""As-rigid-as-possible Laplacian regularization energy.

PyTorch counterpart of ``deodr_tpu/geometry/energy.py``: the graph
Laplacian is applied twice (``TriMeshAdjacencies.laplacian_apply``, an
``index_add`` over the edge list; L is symmetric, so LᵀL·x = L(L·x)), with
no sparse matrix, and the energy is differentiable by autograd as well.
"""

from __future__ import annotations

import numpy as np
import torch

from deodr_tpu_torch.geometry.mesh import TriMesh


def _count_components(edges: np.ndarray, nb_vertices: int) -> int:
    """Union-find connected-component count over the edge list."""
    parent = np.arange(nb_vertices)

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    for a, b in edges:
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[ra] = rb
    return len({find(i) for i in range(nb_vertices)})


class LaplacianRigidEnergy:
    """E(V) = ½·cregu·‖L(V − V_ref)‖² with L the graph Laplacian.

    ``evaluate`` returns (energy, gradient, approx_hessian_matvec), the
    gradient cregu·LᵀL(V − V_ref), in the dtype and on the device of the
    vertices it is given.
    """

    def __init__(self, mesh: TriMesh, vertices, cregu: float):
        self.mesh = mesh
        self.cregu = cregu
        self.vertices_ref = np.asarray(vertices.detach().cpu() if isinstance(vertices, torch.Tensor) else vertices,
                                       dtype=np.float64)
        self._ref_on_device: dict = {}
        adj = mesh.adjacencies
        if _count_components(adj.edges, adj.nb_vertices) > 1:
            raise ValueError("You have more than one connected component in your mesh.")

    def _ref(self, like: torch.Tensor) -> torch.Tensor:
        key = (like.device, like.dtype)
        if key not in self._ref_on_device:
            self._ref_on_device[key] = torch.as_tensor(self.vertices_ref, dtype=like.dtype, device=like.device)
        return self._ref_on_device[key]

    def evaluate(self, vertices: torch.Tensor):
        adj = self.mesh.adjacencies
        diff = vertices - self._ref(vertices)
        l_diff = adj.laplacian_apply(diff)
        grad = self.cregu * adj.laplacian_apply(l_diff)
        energy = 0.5 * (diff * grad).sum()
        return energy, grad, self.approx_hessian_matvec

    def approx_hessian_matvec(self, x: torch.Tensor) -> torch.Tensor:
        adj = self.mesh.adjacencies
        return self.cregu * adj.laplacian_apply(adj.laplacian_apply(x))
