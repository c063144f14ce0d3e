"""Differentiable 3D transform helpers (plain torch, gradients by autograd).

PyTorch counterpart of ``deodr_tpu/geometry/transforms.py``: ``normalize``
and ``qrot`` (single or batched quaternions), ``cross2``, and the numpy
finite-difference Jacobian helpers, which work through any pipeline,
stateful fitters included.
"""

from __future__ import annotations

import numpy as np
import torch


def normalize(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """x / ||x|| along ``dim``."""
    return x / torch.sqrt((x**2).sum(dim=dim, keepdim=True))


def qrot(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate points ``v`` (N, 3) by a unit quaternion ``q`` (4,) → (N, 3),
    or by each of a batch of quaternions (B, 4) → (B, N, 3).

    Quaternion layout is (x, y, z, w), as in scipy.
    """
    if q.ndim == 2:
        axis, w, v = q[:, None, :3], q[:, None, 3:4], v[None, :, :]
    else:
        axis, w = q[:3], q[3]
    uv = torch.linalg.cross(*torch.broadcast_tensors(axis, v), dim=-1)
    uuv = torch.linalg.cross(*torch.broadcast_tensors(axis, uv), dim=-1)
    return v + 2 * (w * uv + uuv)


def cross2(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """2D cross product u_x v_y - u_y v_x over the last axis."""
    return u[..., 0] * v[..., 1] - u[..., 1] * v[..., 0]


def jacobian_finite_differences(func, x, epsilon: float = 1e-6) -> np.ndarray:
    """Central-difference Jacobian of ``func`` at ``x`` (flattened in and
    out), for numpy in and out."""
    x = np.asarray(x, np.float64)
    f0 = np.asarray(func(x)).ravel()
    jac = np.zeros((f0.size, x.size))
    flat = x.ravel()
    for i in range(flat.size):
        xp = flat.copy()
        xm = flat.copy()
        xp[i] += epsilon
        xm[i] -= epsilon
        fp = np.asarray(func(xp.reshape(x.shape))).ravel()
        fm = np.asarray(func(xm.reshape(x.shape))).ravel()
        jac[:, i] = (fp - fm) / (2 * epsilon)
    return jac


def check_jacobian_finite_differences(jac, func, x, epsilon: float = 1e-6, tol: float = 1e-4) -> float:
    """Assert ``jac`` matches the central-difference Jacobian of ``func`` at
    ``x`` within ``tol`` (max abs error, returned)."""
    jac_fd = jacobian_finite_differences(func, x, epsilon)
    err = float(np.abs(np.asarray(jac).reshape(jac_fd.shape) - jac_fd).max())
    assert err < tol, f"jacobian mismatch: max abs err {err} >= {tol}"
    return err
