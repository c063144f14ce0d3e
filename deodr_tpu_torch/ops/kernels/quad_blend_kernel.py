"""Quad-window bilinear blend, forward and backward.

Counterpart of ``deodr_tpu/ops/pallas/quad_blend_kernel.py`` (``_fwd_kernel``,
``_bwd_kernel`` under the ``quad_blend`` custom VJP), the blend of the
quad-granular texture fetch (:func:`deodr_tpu_torch.ops.common.
bilinear_sample_quads`). Each 2×2 screen quad q has one gathered 8×8 texel
window; pixel p of the quad blends the 4 taps at window offsets (dv, du),
(dv, du+1), (dv+1, du), (dv+1, du+1) with the weights of (ev, eu), in the
operation order of :func:`deodr_tpu_torch.ops.common.bilinear_blend`.

The TPU kernel evaluates a soft one-hot over all 64 window positions with
quads on the lane axis, because a TPU has no cheap gather; here the taps
are read directly (``csrc/quad_blend_kernel.cu`` on a CUDA tensor, the
plain versions below on a CPU tensor or with ``impl="reference"``).

Layouts (Q quads, P pixels per quad, C channels):

- win    (Q, 64·C)  window rows, entry (r·8 + x)·C + c = texel (r, x), channel c
- dv, du (Q, P)     int32 tap offsets in 0..6 (clamped there)
- ev, eu (Q, P)     weights of the second row and column
- out    (Q, P, C)  blended samples
- d_win  (Q, 64·C)  dense window cotangent, 0 where no tap reads
- d_ev, d_eu (Q, P) cotangents of the weights; the offsets get none

The kernel takes P = 4; the plain versions take any P (the per-pixel
fallback of the quad fetch calls the forward one with P = 1).
"""

from __future__ import annotations

import torch

from deodr_tpu_torch.ops import kernels
from deodr_tpu_torch.ops.common import bilinear_blend

# (row, column) of the taps t00, t10, t01, t11 relative to (dv, du)
_TAPS = ((0, 0), (0, 1), (1, 0), (1, 1))


def _tap_rows(q: int, dv, du):
    """Flat row indices into ``win.reshape(Q·64, C)`` of the 4 taps."""
    base = torch.arange(q, device=dv.device)[:, None] * 64 + dv.clamp(0, 6).long() * 8 + du.clamp(0, 6).long()
    return [base + 8 * r + x for r, x in _TAPS]


def _tap_weights(ev, eu):
    """Weights of t00, t10, t01, t11."""
    return ((1 - eu) * (1 - ev), eu * (1 - ev), (1 - eu) * ev, eu * ev)


def quad_blend_fwd_reference(win, dv, du, ev, eu):
    """Plain version of the forward kernel, differentiable in ``win``,
    ``ev`` and ``eu`` by autograd."""
    q, p = dv.shape
    c = win.shape[1] // 64
    flat = win.reshape(q * 64, c)
    taps = [flat.index_select(0, rows.reshape(-1)).reshape(q, p, c) for rows in _tap_rows(q, dv, du)]
    return bilinear_blend(eu[..., None], ev[..., None], taps)


def quad_blend_bwd_reference(win, dv, du, ev, eu, ct):
    """Plain version of the backward kernel → (d_win, d_ev, d_eu). Each
    window entry sums its taps' terms tap by tap, then pixel by pixel (the
    kernel's order); d_ev and d_eu sum over channels in order."""
    q, p = dv.shape
    c = win.shape[1] // 64
    flat = win.reshape(q * 64, c)
    rows = _tap_rows(q, dv, du)
    t00, t10, t01, t11 = (flat.index_select(0, r.reshape(-1)).reshape(q, p, c) for r in rows)
    d_win = torch.zeros((q * 64, c), dtype=win.dtype, device=win.device)
    for r, w in zip(rows, _tap_weights(ev, eu)):
        d_win.index_add_(0, r.reshape(-1), (w[..., None] * ct).reshape(-1, c))
    eu_c, ev_c = eu[..., None], ev[..., None]
    top = (1 - eu_c) * t00 + eu_c * t10
    bot = (1 - eu_c) * t01 + eu_c * t11
    g_ev = ct * (bot - top)
    g_eu = ct * ((t10 - t00) * (1 - ev_c) + (t11 - t01) * ev_c)
    d_ev, d_eu = torch.zeros_like(ev), torch.zeros_like(eu)
    for ch in range(c):
        d_ev = d_ev + g_ev[..., ch]
        d_eu = d_eu + g_eu[..., ch]
    return d_win.reshape(win.shape), d_ev, d_eu


def _check_inputs(win, dv, du, ev, eu):
    kernels.check_float(win, "win")
    if win.ndim != 2 or win.shape[1] % 64 or not 1 <= win.shape[1] // 64 <= 4:
        raise ValueError(f"win: expected (Q, 64·C) with C in 1..4, got {tuple(win.shape)}")
    q, c = win.shape[0], win.shape[1] // 64
    if q * 64 * c >= 2**31:
        raise ValueError("win: the kernel indexes quads with 32-bit integers")
    kernels.check_tensor(win, "win", win.dtype, (q, 64 * c))
    for name, t in (("dv", dv), ("du", du)):
        kernels.check_tensor(t, name, torch.int32, (q, 4))
    for name, t in (("ev", ev), ("eu", eu)):
        kernels.check_tensor(t, name, win.dtype, (q, 4))
    return q, c


def quad_blend_fwd(win, dv, du, ev, eu, impl: str = "kernel"):
    """Forward blend → (Q, 4, C)."""
    if not kernels.use_kernel(win, impl):
        return quad_blend_fwd_reference(win, dv, du, ev, eu)
    q, c = _check_inputs(win, dv, du, ev, eu)
    out = torch.empty((q, 4, c), dtype=win.dtype, device=win.device)
    kernels.launch("quad_blend_fwd", win.dtype, win.data_ptr(), dv.data_ptr(), du.data_ptr(), ev.data_ptr(),
                   eu.data_ptr(), q, c, out.data_ptr())
    return out


def quad_blend_bwd(win, dv, du, ev, eu, ct, impl: str = "kernel"):
    """Backward blend → (d_win (Q, 64·C), d_ev (Q, 4), d_eu (Q, 4))."""
    if not kernels.use_kernel(win, impl):
        return quad_blend_bwd_reference(win, dv, du, ev, eu, ct)
    q, c = _check_inputs(win, dv, du, ev, eu)
    kernels.check_tensor(ct, "ct", win.dtype, (q, 4, c))
    d_win = torch.empty_like(win)
    d_ev, d_eu = torch.empty_like(ev), torch.empty_like(eu)
    kernels.launch("quad_blend_bwd", win.dtype, win.data_ptr(), dv.data_ptr(), du.data_ptr(), ev.data_ptr(),
                   eu.data_ptr(), ct.data_ptr(), q, c, d_win.data_ptr(), d_ev.data_ptr(), d_eu.data_ptr())
    return d_win, d_ev, d_eu


class _QuadBlend(torch.autograd.Function):
    @staticmethod
    def forward(ctx, win, dv, du, ev, eu, impl):
        win, ev, eu = win.contiguous(), ev.contiguous(), eu.contiguous()
        dv, du = dv.contiguous(), du.contiguous()
        ctx.save_for_backward(win, dv, du, ev, eu)
        ctx.impl = impl
        return quad_blend_fwd(win, dv, du, ev, eu, impl)

    @staticmethod
    def backward(ctx, ct):
        win, dv, du, ev, eu = ctx.saved_tensors
        d_win, d_ev, d_eu = quad_blend_bwd(win, dv, du, ev, eu, ct.contiguous(), ctx.impl)
        return d_win, None, None, d_ev, d_eu, None


def quad_blend(win, dv, du, ev, eu, impl: str = "kernel"):
    """Differentiable quad blend (gradients to ``win``, ``ev`` and ``eu``)
    → (Q, 4, C); see the module docstring for the layouts."""
    return _QuadBlend.apply(win, dv, du, ev, eu, impl)
