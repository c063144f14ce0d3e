"""Shared rasterization math: 3x3 inverses, edge equations and the
float32-safe barycentric matrices.

PyTorch counterpart of the subset of ``deodr_tpu/ops/common.py`` that the
tiled render path uses, with the bilinear texture fetch, per pixel and per
2×2 screen quad (``quad_window_table``, ``bilinear_sample_quads``). Gathers are plain indexing here: autograd
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


def floor_div(num: torch.Tensor, den: torch.Tensor, lo, hi) -> torch.Tensor:
    """min(hi, max(lo, floor(num / den))) with the reference's den == 0
    rule: ``hi`` where num ≤ 0, else ``lo`` (the JAX package's
    ``floor_div``; NaN propagates as there)."""
    q = torch.floor(num / torch.where(den == 0, 1.0, den))
    q = torch.minimum(torch.maximum(q, _as(lo, q)), _as(hi, q))
    return torch.where(den == 0, torch.where(num <= 0, _as(hi, q), _as(lo, q)), q)


def ceil_div(num: torch.Tensor, den: torch.Tensor, lo, hi) -> torch.Tensor:
    """min(hi, max(lo, ceil(num / den))) with the reference's den == 0
    rule: ``hi`` where num < 0, else ``lo`` (the JAX package's
    ``ceil_div``)."""
    q = torch.ceil(num / torch.where(den == 0, 1.0, den))
    q = torch.minimum(torch.maximum(q, _as(lo, q)), _as(hi, q))
    return torch.where(den == 0, torch.where(num < 0, _as(hi, q), _as(lo, q)), q)


def _as(v, like: torch.Tensor) -> torch.Tensor:
    """``v`` (a tensor or a Python number) as a tensor of ``like``'s dtype
    and device, for the NaN-propagating ``torch.maximum`` / ``minimum``."""
    return v if isinstance(v, torch.Tensor) else torch.tensor(v, dtype=like.dtype, device=like.device)


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


def bilinear_coords(u: torch.Tensor, v: torch.Tensor, th: int, tw: int):
    """Weights and first-tap texel of a bilinear fetch at column coordinate
    ``u`` and row coordinate ``v`` in a (th, tw) texture → (eu, ev, iu, iv):
    ``fu = floor(u)``, ``eu`` is 0 where ``fu < 0``, 1 where ``fu > tw − 2``,
    else ``u − fu`` (so a clamped coordinate gets no gradient), and
    ``iu = clip(fu, 0, tw − 2)`` as int64; likewise for ``v``. A non-finite
    coordinate gives the first or the last texel, never one outside."""
    fu, fv = torch.floor(u), torch.floor(v)
    eu = torch.where(fu < 0, 0.0, torch.where(fu > tw - 2, 1.0, u - fu))
    ev = torch.where(fv < 0, 0.0, torch.where(fv > th - 2, 1.0, v - fv))
    # nan_to_num before the cast: a NaN cast to an integer is undefined
    iu = torch.nan_to_num(fu.detach(), nan=0.0).clamp(0, tw - 2).to(torch.int64)
    iv = torch.nan_to_num(fv.detach(), nan=0.0).clamp(0, th - 2).to(torch.int64)
    return eu, ev, iu, iv


def bilinear_taps(texture: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """The 2×2 footprint of a bilinear fetch at column coordinate ``u`` and
    row coordinate ``v`` (same shape) in ``texture`` (th, tw, C) →
    (eu, ev, idx, (t00, t10, t01, t11)): the weights of the second column
    and row, the flat index ``row·tw + column`` of the first tap, and the
    four taps (..., C), tXY at column X, row Y of the footprint.

    Integer texel centers with border clamp (see :func:`bilinear_coords`).
    The taps are fetched directly; autograd accumulates the texture
    gradient over overlapping footprints (``index_add_``).
    """
    th, tw, c = texture.shape
    eu, ev, iu, iv = bilinear_coords(u, v, th, tw)
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


def quad_window_table(texture: torch.Tensor) -> torch.Tensor:
    """Stride-2 8×8 texel window table of a (th, tw, C) texture →
    (th//2 · tw//2, 64·C): row (bv, bu) holds ``texture[2bv : 2bv+8,
    2bu : 2bu+8]`` flattened (row, column, channel), zero past the far
    borders (those texels are never read: taps are clamped to the texture).
    A window at an even origin covers every set of taps that spans at most
    6 texels, as the taps of a 2×2 screen quad usually do. Built with
    ``unfold``; its backward adds each window entry's cotangent back into
    its texel."""
    th, tw, c = texture.shape
    texp = torch.nn.functional.pad(texture, (0, 0, 0, 6, 0, 6))
    win = texp.unfold(0, 8, 2).unfold(1, 8, 2)  # (th//2, tw//2, C, 8, 8)
    return win.permute(0, 1, 3, 4, 2).reshape((th // 2) * (tw // 2), 64 * c)


def bilinear_sample_quads(texture: torch.Tensor, uv_q: torch.Tensor, mask_q: torch.Tensor, fallback_capacity: int,
                          checks=None, impl: str = "kernel") -> torch.Tensor:
    """Bilinear texture fetch with one window-table row per 2×2 pixel quad.

    ``uv_q`` (Q, 4, 2): pixel (u, v) grouped by screen quad; ``mask_q``
    (Q, 4) bool: the pixels that use their sample (the others get an
    arbitrary in-window value; callers mask them out). Returns (Q, 4, C),
    equal per masked pixel to :func:`bilinear_sample` (same taps, same
    blend order).

    Each quad's window origin is the even texel at or below the smallest tap
    of its masked pixels. Quads whose taps reach past the window (span over
    6 texels: uv seams, minification) are re-fetched pixel by pixel through
    a compacted list of static ``fallback_capacity`` slots; quads beyond it
    keep the (wrong) clamped-window sample, a capacity event that
    ``checks`` reports ("quad-fetch fallback compaction"). The main pass
    blends through :func:`deodr_tpu_torch.ops.kernels.quad_blend_kernel.
    quad_blend` (the kernel on a CUDA tensor with ``impl="kernel"``).
    """
    from deodr_tpu_torch.ops.kernels.quad_blend_kernel import quad_blend, quad_blend_fwd_reference
    from deodr_tpu_torch.ops.tiled import _compact_bins

    th, tw, c = texture.shape
    n_bu = tw // 2
    q = uv_q.shape[0]
    table = quad_window_table(texture)
    eu, ev, iu, iv = bilinear_coords(uv_q[..., 0], uv_q[..., 1], th, tw)  # (Q, 4)
    org_u = 2 * (torch.where(mask_q, iu, tw - 2).amin(dim=1) // 2)  # (Q,)
    org_v = 2 * (torch.where(mask_q, iv, th - 2).amin(dim=1) // 2)
    du = iu - org_u[:, None]  # ≥ 0 for masked pixels
    dv = iv - org_v[:, None]
    bad = (mask_q & ((du > 6) | (dv > 6))).any(dim=1)  # (Q,)
    rows = (org_v // 2) * n_bu + org_u // 2
    win = table.index_select(0, rows)  # (Q, 64C): the one row gather per quad
    offsets = (dv.clamp(0, 6).to(torch.int32), du.clamp(0, 6).to(torch.int32))
    samples = quad_blend(win, *offsets, ev, eu, impl)
    if fallback_capacity <= 0:
        return samples
    if checks is not None:
        checks.append(("quad-fetch fallback compaction", bad.sum(), fallback_capacity))

    # the oversize quads, re-fetched per pixel: one pixel's taps span 2
    # texels, so a window at the pixel's own even origin always holds them
    cap_b = min(fallback_capacity, q)
    ids, valid, _ = _compact_bins(bad[None, :], cap_b)
    ids, valid = ids[0], valid[0]
    # the padding slots all repeat quad 0: the differentiable gathers are
    # index_select (one index_add_ backward), not plain indexing
    iu_f, iv_f = iu[ids], iv[ids]  # (B, 4)
    org_u_f, org_v_f = 2 * (iu_f // 2), 2 * (iv_f // 2)
    win_f = table.index_select(0, ((org_v_f // 2) * n_bu + org_u_f // 2).reshape(-1))  # (4B, 64C)
    samples_f = quad_blend_fwd_reference(
        win_f, (iv_f - org_v_f).reshape(-1, 1), (iu_f - org_u_f).reshape(-1, 1),
        ev.index_select(0, ids).reshape(-1, 1), eu.index_select(0, ids).reshape(-1, 1),
    ).reshape(cap_b, 4, c)
    # invalid slots point at quad 0: zero them so no gradient leaks through their gathers
    samples_f = samples_f * valid[:, None, None].to(samples_f.dtype)
    # overwrite the fallback quads (out of place: autograd then drops the
    # overwritten rows' cotangents); unused slots write a dummy row
    padded = torch.cat([samples, samples.new_zeros((1, 4, c))], dim=0)
    dest = torch.where(valid, ids, q)
    return padded.index_copy(0, dest, samples_f)[:q]
