"""Shared rasterization math: 3x3 inverses, edge equations and the
float32-safe barycentric matrices.

PyTorch counterpart of the subset of ``deodr_tpu/ops/common.py`` that the
tiled render path uses, with the bilinear texture fetch. Gathers are plain indexing here: autograd
turns them into ``index_add`` in the backward, which is what the JAX
package's ``gather_rows_mm`` one-hot contraction emulates on the TPU.
Small contractions (3 terms) are written out as sums of products, so no
float32 matrix product (and no TF32) is involved.
"""

from __future__ import annotations

import torch


def inv3x3(m: torch.Tensor) -> torch.Tensor:
    """Closed-form cofactor inverse of (..., 3, 3) matrices; differentiable
    by autograd (same operation order as the JAX package's ``inv3x3``)."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    co00 = e * i - f * h
    co01 = c * h - b * i
    co02 = b * f - c * e
    co10 = f * g - d * i
    co11 = a * i - c * g
    co12 = c * d - a * f
    co20 = d * h - e * g
    co21 = b * g - a * h
    co22 = a * e - b * d
    det = a * co00 + b * co10 + c * co20
    adj = torch.stack(
        [
            torch.stack([co00, co01, co02], dim=-1),
            torch.stack([co10, co11, co12], dim=-1),
            torch.stack([co20, co21, co22], dim=-1),
        ],
        dim=-2,
    )
    return adj / det[..., None, None]


def edge_equations(v_xy: torch.Tensor, local_clockwise: torch.Tensor) -> torch.Tensor:
    """Per-triangle edge line equations a·x + b·y + c = 0, interior on the
    positive side, for edges (v0,v1), (v1,v2), (v2,v0).

    ``local_clockwise`` is the screen-space winding of each triangle.
    v_xy: (..., 3, 2) → (..., 3, 3).
    """
    v1 = v_xy
    v2 = torch.roll(v_xy, -1, dims=-2)  # (v1, v2, v0)
    sign = torch.where(local_clockwise[..., None], 1.0, -1.0).to(v_xy.dtype)
    a = sign * (v1[..., 1] - v2[..., 1])
    b = sign * (v2[..., 0] - v1[..., 0])
    c = -0.5 * (a * (v1[..., 0] + v2[..., 0]) + b * (v1[..., 1] + v2[..., 1]))
    return torch.stack([a, b, c], dim=-1)


def barycentric_matrices(v_xy: torch.Tensor) -> torch.Tensor:
    """inv([[x0,x1,x2],[y0,y1,y2],[1,1,1]]): maps homogeneous pixel coords
    (x, y, 1) to barycentric coordinates."""
    ones = torch.ones_like(v_xy[..., 0])
    m = torch.stack([v_xy[..., 0], v_xy[..., 1], ones], dim=-2)
    return inv3x3(m)


def safe_barycentric_matrices(v_xy: torch.Tensor):
    """:func:`barycentric_matrices` that cannot produce inf/NaN; returns
    ``(inv, valid)``.

    In float32 the cofactor determinant of a sliver triangle at image
    coordinates cancels to exactly 0, and a singular inverse poisons the
    backward even where every use is masked. So below 64 bits the matrix is
    built from edge differences, and degenerate triangles are replaced by a
    canonical unit triangle before any division; ``valid`` is false for
    them (they cover no pixels). Float64 keeps the cofactor form.
    """
    use_cofactor = torch.finfo(v_xy.dtype).bits >= 64
    e1 = v_xy[..., 1, :] - v_xy[..., 0, :]
    e2 = v_xy[..., 2, :] - v_xy[..., 0, :]
    det = e1[..., 0] * e2[..., 1] - e2[..., 0] * e1[..., 1]
    eps = torch.finfo(v_xy.dtype).eps
    noise = 100.0 * eps * torch.sqrt(_sum2(e1 * e1) * _sum2(e2 * e2))
    if use_cofactor:
        sq = _sum2(v_xy * v_xy)
        noise = torch.maximum(noise, 100.0 * eps * torch.amax(sq, dim=-1))
    valid = (
        torch.isfinite(det) & (det.abs() > noise) & torch.isfinite(v_xy).all(dim=-1).all(dim=-1)
    ).detach()
    # [[0, 0], [1, 0], [0, 1]], made on the device (a host tensor would be
    # a blocking copy on every call)
    canon = torch.eye(3, 2, dtype=v_xy.dtype, device=v_xy.device).roll(1, dims=0)
    safe = torch.where(valid[..., None, None], v_xy, canon)
    if use_cofactor:
        return barycentric_matrices(safe), valid
    x0, y0 = safe[..., 0, 0], safe[..., 0, 1]
    e1 = safe[..., 1, :] - safe[..., 0, :]
    e2 = safe[..., 2, :] - safe[..., 0, :]
    det = e1[..., 0] * e2[..., 1] - e2[..., 0] * e1[..., 1]
    row1 = torch.stack([e2[..., 1], -e2[..., 0], e2[..., 0] * y0 - e2[..., 1] * x0], dim=-1) / det[..., None]
    row2 = torch.stack([-e1[..., 1], e1[..., 0], e1[..., 1] * x0 - e1[..., 0] * y0], dim=-1) / det[..., None]
    one = torch.zeros_like(row1)
    one[..., 2] = 1.0
    row0 = one - row1 - row2
    return torch.stack([row0, row1, row2], dim=-2), valid


def _sum2(a: torch.Tensor) -> torch.Tensor:
    """Sum over a last axis of length 2, in a fixed order."""
    return a[..., 0] + a[..., 1]


def sum3(a: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over an axis of length 3 as ((a0 + a1) + a2): a fixed order on
    every device, where ``Tensor.sum`` may reduce in another order."""
    x0, x1, x2 = a.unbind(dim)
    return x0 + x1 + x2


def bilinear_taps(texture: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """The 2×2 footprint of a bilinear fetch at column coordinate ``u`` and
    row coordinate ``v`` (same shape) in ``texture`` (th, tw, C) →
    (eu, ev, idx, (t00, t10, t01, t11)): the weights of the second column
    and row, the flat index ``row·tw + column`` of the first tap, and the
    four taps (..., C), tXY at column X, row Y of the footprint.

    Integer texel centers with border clamp: ``fu = floor(u)``, ``eu`` is 0
    where ``fu < 0``, 1 where ``fu > tw − 2``, else ``u − fu`` (so a
    clamped coordinate gets no gradient), and the first tap sits at
    ``clip(fu, 0, tw − 2)``. A non-finite coordinate reads the first or the
    last footprint, never outside the texture. The taps are fetched
    directly; autograd accumulates the texture gradient over overlapping
    footprints (``index_add_``).
    """
    th, tw, c = texture.shape
    fu, fv = torch.floor(u), torch.floor(v)
    eu = torch.where(fu < 0, 0.0, torch.where(fu > tw - 2, 1.0, u - fu))
    ev = torch.where(fv < 0, 0.0, torch.where(fv > th - 2, 1.0, v - fv))
    # nan_to_num before the cast: a NaN cast to an integer is undefined
    iu = torch.nan_to_num(fu.detach(), nan=0.0).clamp(0, tw - 2).to(torch.int64)
    iv = torch.nan_to_num(fv.detach(), nan=0.0).clamp(0, th - 2).to(torch.int64)
    idx = iv * tw + iu
    flat = texture.reshape(th * tw, c)
    flat_idx = idx.reshape(-1)
    shape = u.shape + (c,)
    taps = tuple(flat.index_select(0, flat_idx + off).reshape(shape) for off in (0, 1, tw, tw + 1))
    return eu, ev, idx, taps


def bilinear_blend(eu: torch.Tensor, ev: torch.Tensor, taps) -> torch.Tensor:
    """The bilinear blend of the four taps of :func:`bilinear_taps` with
    weights eu, ev broadcastable to a tap, in the one operation order every
    sampler of the package (and the CUDA kernel) uses."""
    t00, t10, t01, t11 = taps
    return ((1 - eu) * t00 + eu * t10) * (1 - ev) + ((1 - eu) * t01 + eu * t11) * ev


def bilinear_sample(texture: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Bilinear texture fetch: texture (th, tw, C), p (..., 2) → (..., C).
    ``p[..., 0]`` indexes columns (u), ``p[..., 1]`` rows (v); the sample at
    (0.0, 0.0) is exactly ``texture[0, 0]``; see :func:`bilinear_taps` for
    the border rules."""
    eu, ev, _, taps = bilinear_taps(texture, p[..., 0], p[..., 1])
    return bilinear_blend(eu[..., None], ev[..., None], taps)
