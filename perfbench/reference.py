"""Plain PyTorch reference of one cell's fit: render, squared error, the
gradients by autograd, and Adam written out.

It imports nothing of the port. Its semantics are those of DEODR's
``Scene3D.render`` for a vertex-coloured mesh (integer pixel centres,
strict edges, back-face culling, no perspective correction):

- projection ``K·(R·p + t)`` divided by depth; Lambertian shading per
  vertex, ``max(0, −⟨n, l⟩) + ambient`` with ``n`` the normalised sum of
  the unit normals of the faces around the vertex (the max passes half the
  gradient at 0, as DEODR's does), times the vertex colour;
- the solid pass: each front-facing triangle covers the pixel centres
  inside it (the left edge of each scanline part strictly, the right edge
  inclusively, rows below the top vertex down to the bottom one); the
  nearest depth wins, the lowest triangle index on a tie; the winner's
  colour is interpolated linearly in screen space, the background
  elsewhere;
- the edge pass, at σ > 0: along each silhouette edge of a front-facing triangle (an
  edge whose two faces face opposite ways), a band σ wide on its outer
  side is blended over the image, ``buf ← A + T·(buf − A)`` with ``T`` the
  distance to the edge over σ and ``A`` the edge's colour interpolated
  along it, only over strictly farther pixels, edges painted from the
  triangles of largest depth sum to the smallest.

The solid pass decides coverage with the kernels' scanline planes in their
form ``a·x + (b·y + c)``, so pixels are decided alike wherever rounding
allows; colours, depths and bands are interpolated relative to a corner.
The reference computes in float64 whatever the configuration's dtype.
The pixel work runs in blocks of candidate (triangle or edge, pixel) pairs,
so memory stays bounded at 2048² and 131k faces.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from perfbench.inputs import learning_rates

_BLOCK = 1 << 23  # candidate pairs per block


class FitResult(NamedTuple):
    """What the comparison reads from three steps of a fit."""

    losses: list  # loss of each step, floats
    first_grads: dict  # leaf name → gradient of step 1
    params: dict  # leaf name → value after the steps


def _cross(a, b):
    return torch.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1], a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                        a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], dim=1)


def _normalize(x):
    return x / torch.sqrt((x * x).sum(dim=1, keepdim=True))


def _plane(coef, x, y):
    """coef (..., 3) at pixel (x, y): a·x + (b·y + c)."""
    return coef[..., 0] * x + (coef[..., 1] * y + coef[..., 2])


def _blocks(counts: torch.Tensor):
    """Split items with ``counts`` candidates each into runs of about
    ``_BLOCK`` candidates → [(first item, end item)]."""
    cum = counts.cumsum(0)
    total = int(cum[-1]) if len(cum) else 0
    marks = torch.arange(_BLOCK, max(total, _BLOCK), _BLOCK, device=cum.device, dtype=cum.dtype)
    bounds = [0] + sorted(set(torch.searchsorted(cum, marks, right=True).tolist())) + [len(counts)]
    return [(a, b) for a, b in zip(bounds[:-1], bounds[1:]) if b > a]


def _expand(x0, y0, w, h):
    """Every pixel of the boxes [x0, x0 + w) × [y0, y0 + h) → (box, x, y)."""
    n = w * h
    box = torch.repeat_interleave(torch.arange(len(n), device=n.device), n)
    k = torch.arange(len(box), device=n.device) - torch.repeat_interleave(n.cumsum(0) - n, n)
    return box, x0[box] + k % w[box], y0[box] + k // w[box]


class Scene:
    """The fixed part of a scene: faces and their neighbours across each
    edge, camera, light, background, σ and the frame."""

    def __init__(self, faces, extrinsic, intrinsic, height, width, light_directional, light_ambient,
                 background, sigma):
        self.faces = faces
        self.height, self.width, self.sigma = int(height), int(width), float(sigma)
        f = faces.cpu().numpy()
        nf, nv = len(f), int(f.max()) + 1
        # the face across edge (v_k, v_k+1) of each face: the other half of the undirected edge
        a, b = f, np.roll(f, -1, axis=1)
        key = (np.minimum(a, b) * nv + np.maximum(a, b)).reshape(-1)
        order = np.argsort(key, kind="stable")
        twin = np.full(3 * nf, -1, dtype=np.int64)
        same = key[order[:-1]] == key[order[1:]]
        twin[order[:-1][same]] = order[1:][same] // 3
        twin[order[1:][same]] = order[:-1][same] // 3
        if (twin < 0).any():
            raise ValueError("the reference renders closed manifold meshes only")
        self.twin = torch.as_tensor(twin.reshape(nf, 3), device=faces.device)
        self.extrinsic, self.intrinsic = extrinsic, intrinsic
        self.light_directional, self.light_ambient = light_directional, float(light_ambient)
        self.background = background

    def to(self, dtype):
        """The same scene for inputs of ``dtype``."""
        other = object.__new__(Scene)
        other.__dict__.update(self.__dict__)
        other.light_directional = self.light_directional.to(dtype)
        other.background = self.background.to(dtype)
        return other

    # ------------------------------------------------------------------ render

    def project(self, vertices: torch.Tensor):
        """(ij (V, 2) pixel coordinates, depths (V,))."""
        dtype = vertices.dtype
        p = (vertices[:, None, :] * self.extrinsic[:, :3].to(dtype)).sum(-1) + self.extrinsic[:, 3].to(dtype)
        depth = p[:, 2]
        ij = ((p[:, :2] / depth[:, None])[:, None, :] * self.intrinsic[:2, :2].to(dtype)).sum(-1)
        return ij + self.intrinsic[:2, 2].to(dtype), depth

    def front(self, ij, depth):
        """(F,) bool: counter-clockwise on screen and in front of the camera."""
        v_xy = ij[self.faces]
        u, w = v_xy[:, 1] - v_xy[:, 0], v_xy[:, 2] - v_xy[:, 0]
        return (u[:, 0] * w[:, 1] - w[:, 0] * u[:, 1] < 0) & (depth[self.faces] >= 0).all(dim=1)

    def silhouette(self, front):
        """(F, 3) bool: edge (v_k, v_k+1) of a front-facing face whose
        neighbour across it faces away."""
        return (front[:, None] != front[self.twin]) & front[:, None]

    def render(self, vertices: torch.Tensor, colors: torch.Tensor) -> torch.Tensor:
        """The image (H, W, 3), differentiable in ``vertices`` and ``colors``."""
        ij, depth = self.project(vertices)
        faces = self.faces
        tri = vertices[faces]
        face_n = _normalize(_cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]))
        vert_n = _normalize(torch.zeros_like(vertices).index_add(0, faces.reshape(-1), face_n.repeat_interleave(3, 0)))
        x = -(vert_n * self.light_directional).sum(dim=1)
        lum = 0.5 * (x + x.abs()) + self.light_ambient  # max(0, x) with DEODR's gradient of 1/2 at x = 0
        shaded = colors * lum[:, None]

        v_xy = ij[faces]  # (F, 3, 2)
        z = depth[faces]
        front = self.front(ij.detach(), depth.detach())
        image, z_buffer = self._solid(v_xy, z, shaded[faces], front)
        if self.sigma <= 0:
            return image.reshape(self.height, self.width, -1)
        return self._edges(image, z_buffer, ij, depth, shaded, z, front)

    def _solid(self, v_xy, z, corner_colors, front):
        """Winner per pixel (no gradient), then its interpolated colour.
        Barycentrics are taken relative to the first corner,
        b1 = (e2 × r) / det, b2 = (r × e1) / det with r = p − v0."""
        height, width, dtype = self.height, self.width, v_xy.dtype
        dev = v_xy.device
        e1, e2 = v_xy[:, 1] - v_xy[:, 0], v_xy[:, 2] - v_xy[:, 0]
        det = e1[:, 0] * e2[:, 1] - e2[:, 0] * e1[:, 1]
        eps = torch.finfo(dtype).eps
        ok = torch.isfinite(det) & (det.abs() > 100 * eps * torch.sqrt((e1 * e1).sum(1) * (e2 * e2).sum(1)))
        drawn = (front & ok.detach()).nonzero().squeeze(1)
        v0, e1, e2, det = v_xy[drawn, 0], e1[drawn], e2[drawn], det[drawn]

        def bary(t, x, y):
            rx, ry = x - v0[t, 0], y - v0[t, 1]
            b1 = (e2[t, 1] * rx - e2[t, 0] * ry) / det[t]
            b2 = (e1[t, 0] * ry - e1[t, 1] * rx) / det[t]
            return b1, b2

        with torch.no_grad():
            rows = _scanline_rows(v_xy[drawn].detach(), height, width)
            zd = z[drawn].detach()
            x_lo, x_hi, y_lo, y_hi = rows["x_lo"], rows["x_hi"], rows["y_lo"][:, 0], rows["y_hi"][:, 1]
            w_box = (x_hi - x_lo + 1).clamp_min(0).long()
            h_box = (y_hi - y_lo + 1).clamp_min(0).long()
            best = torch.full((height * width,), float("inf"), dtype=dtype, device=dev)
            found = []
            neg_tiny = -torch.finfo(dtype).tiny
            for a, b in _blocks(w_box * h_box):
                box, x, y = _expand(x_lo[a:b].long(), y_lo[a:b].long(), w_box[a:b], h_box[a:b])
                t = box + a
                xf, yf = x.to(dtype), y.to(dtype)
                cov = torch.zeros_like(xf, dtype=torch.bool)
                for part in range(2):
                    in_rows = (yf >= rows["y_lo"][t, part]) & (yf <= rows["y_hi"][t, part])
                    cov |= (in_rows & (_plane(rows["left"][t, part], xf, yf) > 0.0)
                            & (_plane(rows["right"][t, part], xf, yf) > neg_tiny))
                t, x, y, xf, yf = t[cov], x[cov], y[cov], xf[cov], yf[cov]
                b1, b2 = bary(t, xf, yf)
                zz = zd[t, 0] + b1.detach() * (zd[t, 1] - zd[t, 0]) + b2.detach() * (zd[t, 2] - zd[t, 0])
                keep = torch.isfinite(zz)
                pix, zz, t = y[keep] * width + x[keep], zz[keep], t[keep]
                best.scatter_reduce_(0, pix, zz, "amin")
                found.append((pix, zz, t))
            winner = torch.full((height * width,), len(drawn), dtype=torch.long, device=dev)
            for pix, zz, t in found:
                hit = zz == best[pix]
                winner.scatter_reduce_(0, pix[hit], t[hit], "amin")
            covered = (winner < len(drawn)).nonzero().squeeze(1)
            win = winner[covered]
        # the winner's colour, differentiable in its corners' positions and colours
        b1, b2 = bary(win, (covered % width).to(dtype), (covered // width).to(dtype))
        c = corner_colors[drawn][win]  # (P, 3, C)
        vals = c[:, 0] + b1[:, None] * (c[:, 1] - c[:, 0]) + b2[:, None] * (c[:, 2] - c[:, 0])
        image = self.background[None, :].repeat(height * width, 1).index_put((covered,), vals)
        return image, best

    def _edges(self, image, z_buffer, ij, depth, shaded, z, front):
        """The silhouette bands, blended in painter's order. Along an edge
        v0 → v1 with d = v1 − v0 and the outward unit normal n, a pixel p
        has b1 = (p − v0)·d / |d|², b0 = 1 − b1 and T = (p − v0)·n / σ; it
        is in the band where all four of b0, b1, T and 1 − T are positive."""
        height, width, sigma = self.height, self.width, self.sigma
        dtype, dev = ij.dtype, ij.device
        faces = self.faces
        active = self.silhouette(front)  # (F, 3): edge (v_k, v_k+1)
        depth_sum = (z[:, 0] + z[:, 1]) + z[:, 2]
        order = torch.sort(depth_sum.detach(), descending=True, stable=True).indices
        rank = torch.empty_like(order)
        rank[order] = torch.arange(len(order), device=dev)
        f_idx, k_idx = active.nonzero(as_tuple=True)
        srt = torch.argsort(rank[f_idx] * 3 + k_idx)
        f_idx, k_idx = f_idx[srt], k_idx[srt]  # painter's order
        i0 = faces[f_idx, (k_idx + 1) % 3]
        i1 = faces[f_idx, k_idx]
        v0 = ij[i0]
        d = ij[i1] - v0
        len2 = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]
        eps = torch.finfo(dtype).eps
        scale2 = ((v0 * v0).sum(1) + (ij[i1] * ij[i1]).sum(1)).clamp_min(1.0)
        usable = (torch.isfinite(len2) & (len2 > (100 * eps) ** 2 * scale2)).detach()
        d = torch.where(usable[:, None], d, torch.tensor([1.0, 0.0], dtype=dtype, device=dev))
        len2 = torch.where(usable, len2, 1.0)
        n = torch.stack([d[:, 1], -d[:, 0]], dim=1) / torch.sqrt(len2)[:, None]  # away from the triangle
        a0, a1 = shaded[i0], shaded[i1]
        z0, z1 = depth[i0].detach(), depth[i1].detach()

        def band(e, x, y):
            rx, ry = x - v0[e, 0], y - v0[e, 1]
            b1 = (rx * d[e, 0] + ry * d[e, 1]) / len2[e]
            return b1, (rx * n[e, 0] + ry * n[e, 1]) / sigma

        with torch.no_grad():
            lo = torch.minimum(v0, v0 + d).detach()
            hi = torch.maximum(v0, v0 + d).detach()
            y_beg = (torch.floor(lo[:, 1] - sigma) + 1).clamp_min(0)
            y_end = torch.floor(hi[:, 1] + sigma).clamp_max(height - 1)
            x_beg = torch.floor(lo[:, 0] - sigma).clamp_min(0)
            x_end = (torch.floor(hi[:, 0] + sigma) + 1).clamp_max(width - 1)
            w_box = torch.where(usable, (x_end - x_beg + 1).clamp_min(0), 0).long()
            h_box = torch.where(usable, (y_end - y_beg + 1).clamp_min(0), 0).long()
            pairs = []
            for lo_e, hi_e in _blocks(w_box * h_box):
                box, x, y = _expand(x_beg[lo_e:hi_e].long(), y_beg[lo_e:hi_e].long(), w_box[lo_e:hi_e],
                                    h_box[lo_e:hi_e])
                e = box + lo_e
                xf, yf = x.to(dtype), y.to(dtype)
                b1, t = band(e, xf, yf)
                pix = y * width + x
                z_px = z0[e] + b1 * (z1[e] - z0[e])
                keep = (b1 > 0) & (1 - b1 > 0) & (t > 0) & (1 - t > 0) & (z_px < z_buffer[pix])
                pairs.append((pix[keep], e[keep]))
            pix = torch.cat([p for p, _ in pairs]) if pairs else torch.zeros(0, dtype=torch.long, device=dev)
            e = torch.cat([q for _, q in pairs]) if pairs else pix
            srt = torch.argsort(pix * (len(f_idx) + 1) + e)  # by pixel, then painter's order
            pix, e = pix[srt], e[srt]
            first = torch.ones_like(pix, dtype=torch.bool)
            first[1:] = pix[1:] != pix[:-1]
            start = torch.cummax(torch.where(first, torch.arange(len(pix), device=dev), 0), 0).values
            level = torch.arange(len(pix), device=dev) - start
        b1, t_px = band(e, (pix % width).to(dtype), (pix // width).to(dtype))
        a_px = a0[e] + b1[:, None] * (a1[e] - a0[e])  # (P, C)
        for lv in range(int(level.max()) + 1 if len(level) else 0):
            sel = level == lv
            p = pix[sel]
            cur = image[p]
            image = image.index_put((p,), a_px[sel] + t_px[sel, None] * (cur - a_px[sel]))
        return image.reshape(height, width, -1)


def _scanline_rows(v_xy, height, width):
    """Per-triangle scanline setup: the two parts' row ranges and their
    left and right edge planes, sign-normalised so that a pixel is inside
    a part where left > 0 and right ≥ 0; the clamped bounding box."""
    y0, y1, y2 = v_xy[:, 0, 1], v_xy[:, 1, 1], v_xy[:, 2, 1]
    x0, x1, x2 = v_xy[:, 0, 0], v_xy[:, 1, 0], v_xy[:, 2, 0]
    u, w = v_xy[:, 1] - v_xy[:, 0], v_xy[:, 2] - v_xy[:, 0]
    sign = torch.where(u[:, 0] * w[:, 1] - w[:, 0] * u[:, 1] > 0, 1.0, -1.0).to(v_xy.dtype)[:, None]
    nxt = torch.roll(v_xy, -1, dims=1)
    a = sign * (v_xy[..., 1] - nxt[..., 1])
    b = sign * (nxt[..., 0] - v_xy[..., 0])
    c = -0.5 * (a * (v_xy[..., 0] + nxt[..., 0]) + b * (v_xy[..., 1] + nxt[..., 1]))
    eq = torch.stack([a, b, c], dim=-1)  # (T, 3, 3): edges (v0, v1), (v1, v2), (v2, v0), inside positive
    top = torch.where((y0 <= y1) & (y0 <= y2), 0, torch.where(y1 <= y2, 1, 2))
    bottom = torch.where((y2 >= y0) & (y2 >= y1), 2, torch.where(y1 >= y0, 1, 0))
    ys0 = torch.minimum(torch.minimum(y0, y1), y2)
    ys2 = torch.maximum(torch.maximum(y0, y1), y2)
    ys1 = torch.maximum(torch.minimum(y0, y1), torch.minimum(torch.maximum(y0, y1), y2))
    ar = torch.arange(len(v_xy), device=v_xy.device)

    def edge(k):
        return eq[ar, k]

    top_prev, bottom_prev = (top + 2) % 3, (bottom + 2) % 3
    a_top, a_bottom = edge(top)[:, 0], edge(bottom)[:, 0]
    left = torch.stack([torch.where((a_top > 0)[:, None], edge(top), edge(top_prev)),
                        torch.where((a_bottom < 0)[:, None], edge(bottom_prev), edge(bottom))], dim=1)
    right = torch.stack([torch.where((a_top > 0)[:, None], edge(top_prev), edge(top)),
                         torch.where((a_bottom < 0)[:, None], edge(bottom), edge(bottom_prev))], dim=1)
    left = torch.where(left[..., 0:1] > 0, left, -left)
    right = torch.where(right[..., 0:1] > 0, -right, right)
    return dict(
        left=left, right=right,
        y_lo=torch.stack([torch.floor(ys0) + 1, torch.floor(ys1) + 1], dim=1).clamp_min(0),
        y_hi=torch.stack([torch.floor(ys1), torch.floor(ys2)], dim=1).clamp_max(height - 1),
        x_lo=torch.floor(torch.minimum(torch.minimum(x0, x1), x2)).clamp_min(0),
        x_hi=torch.floor(torch.maximum(torch.maximum(x0, x1), x2)).clamp_max(width - 1),
    )


def loss_and_grads(scene: Scene, target: torch.Tensor, vertices: torch.Tensor, colors: torch.Tensor,
                   half_rows: bool = False):
    """(loss, grad of vertices, grad of colours) of Σ (render − target)².
    ``half_rows`` is a planted fault: the loss over the top half of the rows,
    doubled."""
    v = vertices.detach().requires_grad_(True)
    c = colors.detach().requires_grad_(True)
    err = (scene.render(v, c) - target.to(v.dtype)) ** 2
    loss = 2 * err[: scene.height // 2].sum() if half_rows else err.sum()
    g_v, g_c = torch.autograd.grad(loss, (v, c))
    return loss.detach(), g_v, g_c


def adam_fit(scene: Scene, target, vertices, colors, traffic: dict, steps: int = 3,
             dtype: torch.dtype = torch.float64) -> FitResult:
    """``steps`` Adam steps of the fit from (``vertices``, ``colors``), with
    the traffic's learning rates, betas and eps, computed in ``dtype``."""
    scene = scene.to(dtype)
    params = {"vertices": vertices.detach().to(dtype), "colors": colors.detach().to(dtype)}
    lrs = learning_rates(traffic, vertices)
    beta1, beta2 = traffic["betas"]
    eps = float(traffic["eps"])
    m = {k: torch.zeros_like(p) for k, p in params.items()}
    v = {k: torch.zeros_like(p) for k, p in params.items()}
    losses, first = [], {}
    for step in range(1, steps + 1):
        loss, g_v, g_c = loss_and_grads(scene, target, params["vertices"], params["colors"])
        losses.append(float(loss))
        grads = {"vertices": g_v, "colors": g_c}
        if step == 1:
            first = {k: g.clone() for k, g in grads.items()}
        for k, g in grads.items():
            m[k] = beta1 * m[k] + (1 - beta1) * g
            v[k] = beta2 * v[k] + (1 - beta2) * g * g
            m_hat = m[k] / (1 - beta1**step)
            v_hat = v[k] / (1 - beta2**step)
            params[k] = params[k] - lrs[k] * m_hat / (torch.sqrt(v_hat) + eps)
    return FitResult(losses, first, params)
