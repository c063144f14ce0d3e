"""Scene3D: one mesh, one directional and one ambient light, rendered and
differentiated through :func:`deodr_tpu_torch.render_scene`.

PyTorch counterpart of ``Scene3D`` in ``deodr_tpu/scene.py`` (render,
render_backward, render_depth and its backward, with the planner
``_eager_plan``). The JAX class jits one pure function per plan and
differentiates it with ``jax.vjp``; here ``render`` runs eagerly with the
autograd graph recorded, and ``render_backward`` runs autograd from the
image cotangent, storing the gradients under the JAX attribute names
(``mesh._vertices_b``, ``mesh.vertices_colors_b``, ``mesh.uv_b``,
``mesh.texture_b``, ``light_directional_b``, ``light_ambient_b``) as
tensors on the scene's device.

The planner plans for the tiled kernel route (128-wide tiles), except for
a mesh of at most 256 faces or ``impl="brute"``, which get no tiling and
render through the untiled pass with the sequential edge pass in the
planner's windows, as in the JAX package. ``render_deferred``,
compare-and-backward and ``Scene2D`` belong to a later part of the port.
"""

from __future__ import annotations

import collections
import math
import os
from typing import Optional

import numpy as np
import torch

from deodr_tpu_torch.camera import Camera
from deodr_tpu_torch.geometry.mesh import ColoredTriMesh
from deodr_tpu_torch.ops.edge_aa import EdgeData
from deodr_tpu_torch.ops.render import SceneBuffers, render_scene
from deodr_tpu_torch.ops.tiled import (
    EdgeTexPlan,
    TilingConfig,
    _edge_band_tile_mask,
    _grid,
    _occupancy_counts,
    split_edges,
)

# supertile shape (in tiles) of two-level binning (deodr_tpu/scene.py:31-32)
_SUPER_TY = 8
_SUPER_TX = 4
# texture-fetch block widths the planner weighs against the tile width
# (deodr_tpu/scene.py:37)
_TEX_BW_CANDIDATES = (32, 64)
_TILE_W = 128
# edge-pass cost model of untextured scenes: ms per band-tile visit and per
# pixel of a visited tile (deodr_tpu/scene.py:727, fitted there on a TPU; kept
# so that the plan is the JAX package's)
_F_VISIT, _C_PX = 1.63e-4, 1.64e-8
_PLAN_CACHE_MAX = 128


def _bucket(n, margin=1.5):
    """Capacity for an occupancy ``n``: n·margin rounded up to a power of two, at least 8."""
    n = max(1, int(math.ceil(n * margin)))
    return max(8, int(2 ** math.ceil(math.log2(n))))


def _tile_heights(height):
    """The solid tile heights a plan can pick: 16 rows for short
    triangles, 48 for tall ones, at most the image's height (and at least
    8); deodr_tpu/scene.py:680-694 for the kernel route."""
    return min(16, max(8, height)), min(48, max(8, height))


def _edge_tile_heights(height):
    """The edge tile heights of the untextured edge-pass cost model
    (deodr_tpu/scene.py:733)."""
    return tuple(th for th in (8, 16, 32, 48) if th <= max(8, height))


def _pow2(n, lo):
    return max(lo, int(2 ** np.ceil(np.log2(max(int(n), 1)))))


def edge_window(span_y: float, span_x: float, sigma: float, height: int, width: int):
    """The sequential edge pass's window for bands whose edges span at most
    ``span_y`` rows and ``span_x`` columns: the largest band's bounding box
    (span + 2σ + 4) rounded up to powers of two, at least 8 rows and 128
    columns, at most the frame; None where it would cover more than a
    quarter of the frame (the full-frame pass is then as cheap). The rule
    of the JAX planner (``deodr_tpu/scene.py``, ``_eager_plan``)."""
    wh = min(_pow2(max(int(span_y + 2 * sigma + 4), 8), 1), height)
    ww = min(_pow2(max(int(span_x + 2 * sigma + 4), 128), 1), width)
    return (wh, ww) if wh * ww * 4 <= height * width else None


class Scene3D:
    """A 3D scene: one mesh, one directional and one ambient light.

    ``device`` (default ``cuda``; asking for CUDA where there is none
    raises) holds every tensor of the render; the mesh's vertex dtype is the
    render's dtype. ``impl="kernel"`` runs the CUDA kernels on a CUDA device
    (a CPU device always takes their plain versions), ``impl="reference"``
    the plain versions anywhere. ``quad_fetch`` turns on the quad-granular
    texture fetch (kernel B4) of textured plans; ``None`` reads the
    ``DEODR_QUAD_FETCH`` environment variable as the JAX planner does.
    """

    def __init__(self, sigma: float = 1, perspective_correct: bool = False, integer_pixel_centers: bool = True,
                 device=None, impl: str = "kernel", quad_fetch: Optional[bool] = None):
        if impl not in ("kernel", "reference", "brute"):
            raise ValueError(f"impl must be 'kernel', 'reference' or 'brute', got {impl!r}")
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("CUDA was requested but torch.cuda.is_available() is False; pass device='cpu'")
        self.impl = impl
        self.quad_fetch = quad_fetch
        self.sigma = sigma
        self.perspective_correct = perspective_correct
        self.integer_pixel_centers = integer_pixel_centers
        self.mesh: Optional[ColoredTriMesh] = None
        self.light_directional: Optional[np.ndarray] = None
        self.light_ambient: float = 0
        self.background_image: Optional[np.ndarray] = None
        self.background_color: Optional[np.ndarray] = None
        self._store: Optional[dict] = None
        self._last_plan: collections.OrderedDict = collections.OrderedDict()

    def set_light(self, light_directional, light_ambient) -> None:
        self.light_directional = None if light_directional is None else np.asarray(light_directional)
        self.light_ambient = light_ambient

    def set_mesh(self, mesh: ColoredTriMesh) -> None:
        self.mesh = mesh

    def set_background_image(self, background_image) -> None:
        if self.background_color is not None:
            raise ValueError("you cannot provide both background image and background color")
        background_image = np.asanyarray(background_image)
        if background_image.ndim != 3:
            raise ValueError("the background image must be (H, W, C)")
        self.background_image = background_image

    def set_background_color(self, background_color) -> None:
        if self.background_image is not None:
            raise ValueError("you cannot provide both background image and background color")
        background_color = np.asanyarray(background_color, dtype=np.float64)
        if background_color.ndim != 1:
            raise ValueError("the background color must be (C,)")
        self.background_color = background_color

    # ------------------------------------------------------------ the render

    def _dtype(self) -> torch.dtype:
        dtype = self.mesh.vertices.dtype
        if not dtype.is_floating_point:
            raise ValueError(f"the mesh's vertices must be floating point, got {dtype}")
        return dtype

    def _tensor(self, a) -> Optional[torch.Tensor]:
        # dtype given to as_tensor: a Python float would first become a float32 tensor
        return None if a is None else torch.as_tensor(a, dtype=self._dtype(), device=self.device)

    def _luminosity(self, vertices, light_directional, light_ambient):
        """max(0, −⟨n, l⟩) + ambient per vertex, n the vertex normals;
        max(0, x) is written 0.5·(x + |x|), whose gradient at a tie is 0.5
        as ``jnp.maximum`` gives."""
        if light_directional is not None:
            adj = self.mesh.adjacencies
            normals = adj.compute_vertex_normals(adj.compute_face_normals(vertices))
            x = -(normals * light_directional).sum(dim=1)
            directional = 0.5 * (x + x.abs())
        else:
            directional = torch.zeros_like(vertices[:, 0])
        return directional + light_ambient

    def compute_vertices_luminosity(self) -> torch.Tensor:
        return self._luminosity(self._tensor(self.mesh.vertices), self._tensor(self.light_directional),
                                self.light_ambient)

    def _build_buffers(self, camera: Camera, vertices, vertices_colors, light_directional, light_ambient, uv,
                       texture, backface_culling: bool, depth_only_scale: Optional[float] = None):
        """The :class:`SceneBuffers` of this view → (buffers, depths)."""
        mesh = self.mesh
        points_2d, depths = camera.project_points(vertices)
        if self.sigma > 0:
            edgeflags = mesh.edge_on_silhouette(points_2d.detach())
        else:
            edgeflags = torch.zeros((mesh.nb_faces, 3), dtype=torch.bool, device=self.device)
        faces = mesh._index("faces", self.device)
        nbv, nbf = mesh.nb_vertices, mesh.nb_faces
        dtype = points_2d.dtype
        no_faces = torch.zeros((nbf,), dtype=torch.bool, device=self.device)
        common = dict(
            faces=faces, ij=points_2d, depths=depths, edgeflags=edgeflags,
            background_image=self._tensor(self.background_image), background_color=self._tensor(self.background_color),
            height=camera.height, width=camera.width, clockwise=mesh.clockwise, backface_culling=backface_culling,
            strict_edge=True, perspective_correct=self.perspective_correct,
            integer_pixel_centers=self.integer_pixel_centers,
        )
        zeros_uv = torch.zeros((nbv, 2), dtype=dtype, device=self.device)
        zeros_v = torch.zeros((nbv,), dtype=dtype, device=self.device)
        if depth_only_scale is not None:
            return SceneBuffers(faces_uv=faces, uv=zeros_uv, shade=zeros_v, colors=depths[:, None] * depth_only_scale,
                                textured=no_faces, shaded=no_faces, texture=None, **common), depths
        if uv is not None:
            shade = self._luminosity(vertices, light_directional, light_ambient)
            colors = torch.zeros((nbv, texture.shape[2]), dtype=dtype, device=self.device)
            all_faces = torch.ones((nbf,), dtype=torch.bool, device=self.device)
            return SceneBuffers(faces_uv=mesh._index("faces_uv", self.device), uv=uv, shade=shade, colors=colors,
                                textured=all_faces, shaded=all_faces, texture=texture, **common), depths
        lum = self._luminosity(vertices, light_directional, light_ambient)
        return SceneBuffers(faces_uv=faces, uv=zeros_uv, shade=zeros_v, colors=vertices_colors * lum[:, None],
                            textured=no_faces, shaded=no_faces, texture=None, **common), depths

    _GRAD_NAMES = ("vertices", "vertices_colors", "light_directional", "light_ambient", "uv", "texture")

    def _diff_inputs(self, depth_only: bool):
        """Leaf tensors (or None) in the order of :attr:`_GRAD_NAMES`."""
        mesh = self.mesh
        has_uv = mesh.uv is not None and not depth_only

        def leaf(a):
            return None if a is None else self._tensor(a).detach().requires_grad_(True)

        return (leaf(mesh.vertices), leaf(mesh.vertices_colors), leaf(self.light_directional),
                leaf(float(self.light_ambient)), leaf(mesh.uv) if has_uv else None,
                leaf(mesh.texture) if has_uv else None)

    def _render(self, camera, backface_culling, depth_only_scale, check_capacity):
        if self.mesh is None:
            raise ValueError("you need to provide a mesh first")
        cap, tiling, aa_window, aa_tex_window, aa_tex_plan = self._eager_plan(camera, backface_culling)
        leaves = self._diff_inputs(depth_only_scale is not None)
        buffers, _ = self._build_buffers(camera, *leaves, backface_culling, depth_only_scale)
        impl = "reference" if self.impl == "reference" else "kernel"
        image, z_buffer, _ = render_scene(
            buffers, float(self.sigma), aa_edge_capacity=cap, tiling=tiling, impl=impl, aa_window=aa_window,
            aa_tex_window=aa_tex_window, aa_tex_plan=aa_tex_plan, check_capacity=check_capacity,
        )
        self._store = {"leaves": leaves, "image": image}
        return image.detach(), z_buffer

    def render(self, camera: Camera, return_z_buffer: bool = False, backface_culling: bool = True,
               check_capacity: bool = False):
        """Image (H, W, C) of the mesh seen by ``camera``, and with
        ``return_z_buffer`` the z-buffer (H, W). ``check_capacity=True``
        raises ``RuntimeError`` where a static capacity of the plan
        overflows (see :func:`deodr_tpu_torch.render_scene`)."""
        if (self.background_image is None) == (self.background_color is None):
            raise ValueError("you need to provide either a background image or a background color")
        image, z_buffer = self._render(camera, backface_culling, None, check_capacity)
        return (image, z_buffer) if return_z_buffer else image

    def render_backward(self, image_b) -> None:
        """Back-propagate ``image_b`` (the cotangent of the last render's
        image) to the mesh, the lights and the texture."""
        if self.perspective_correct:
            raise NotImplementedError("perspective_correct is not supported for gradient back propagation")
        if self._store is None or self._store["image"] is None:
            raise RuntimeError("call render or render_depth first (each render supports one backward)")
        image, leaves = self._store["image"], self._store["leaves"]
        used = [x for x in leaves if x is not None]
        grads = torch.autograd.grad(image, used, torch.as_tensor(image_b).to(image.device, image.dtype),
                                    allow_unused=True)
        self._store["image"] = None
        grads = iter(torch.zeros_like(x) if g is None else g for x, g in zip(used, grads))
        g = {name: (None if x is None else next(grads)) for name, x in zip(self._GRAD_NAMES, leaves)}
        mesh = self.mesh
        mesh._vertices_b = g["vertices"]
        mesh.vertices_colors_b = g["vertices_colors"]
        self.light_directional_b = g["light_directional"]
        self.light_ambient_b = g["light_ambient"]
        if g["uv"] is not None:
            mesh.uv_b = g["uv"]
        if g["texture"] is not None:
            mesh.texture_b = g["texture"]

    def render_depth(self, camera: Camera, depth_scale: float = 1, backface_culling: bool = True,
                     check_capacity: bool = False):
        """Depth × ``depth_scale`` as a one-channel image (H, W, 1)."""
        image, _ = self._render(camera, backface_culling, float(depth_scale), check_capacity)
        return image

    def render_depth_backward(self, depth_b) -> None:
        self.render_backward(depth_b)

    # ------------------------------------------------------------ the planner

    def _plan_statistics(self, camera: Camera, backface_culling: bool, want_tiling: bool):
        """The statistics the plan reads, computed on the device with one
        host read → (dict of numpy float32 scalars, ``band_count``).

        Only what the decision reads is measured: triangle occupancy at the
        two solid tile heights the plan can pick (:func:`_tile_heights`),
        the texture-fetch block counts of textured meshes, and for an
        untextured mesh at σ > 0 the edge bands at every edge tile height
        of the cost model. ``band_count(edge_tile_h, aa_tex_plan)`` (σ > 0
        and a texture, else None) counts the largest number of bands in one
        edge tile of a textured mesh once the plan has fixed that height,
        with a second host read: the split segments' bands where the plan
        splits edges, else the whole edges'."""
        mesh = self.mesh
        height, width = camera.height, camera.width
        sigma = float(self.sigma)
        textured = mesh.texture is not None and mesh.uv is not None
        offset = 0.0 if self.integer_pixel_centers else 0.5
        st = {}
        band_count = None
        with torch.no_grad():
            points_2d, depths = camera.project_points(self._tensor(mesh.vertices))
            pts = points_2d - offset
            faces = mesh._index("faces", self.device)
            if sigma > 0:
                flags = mesh.edge_on_silhouette(points_2d) & mesh.adjacencies.face_visible(points_2d)[:, None]
                flat = flags.reshape(-1)
                i0, i1 = faces[:, [1, 2, 0]].reshape(-1), faces[:, [0, 1, 2]].reshape(-1)
                span = (pts[i0] - pts[i1]).abs() * flat[:, None]
                st.update(n_flags=flags.sum(), span_y=span[:, 1].max(), span_x=span[:, 0].max())
                # whole-edge bands, in float32 as the JAX planner counts them
                p0 = (pts[i0] * flat[:, None]).float()
                p1 = (pts[i1] * flat[:, None]).float()
                if textured:
                    faces_uv = mesh._index("faces_uv", self.device)
                    j0, j1 = faces_uv[:, [1, 2, 0]].reshape(-1), faces_uv[:, [0, 1, 2]].reshape(-1)
                    uv = self._tensor(mesh.uv)
                    uspan = (uv[j0] - uv[j1]).abs() * flat[:, None]
                    # segments at a uv length of 12 texels
                    n_seg = torch.where(flat, torch.ceil(uspan.amax(dim=1) / 12.0).clamp_min(1.0), 0.0)
                    st.update(uspan_v=uspan[:, 1].max(), uspan_u=uspan[:, 0].max(), n_seg12=n_seg.sum())
                if mesh.texture is not None:
                    def band_count(edge_tile_h, aa_tex_plan):
                        """Largest number of bands in one edge tile (before the occlusion cull)."""
                        grid = _grid(height, width, edge_tile_h, _TILE_W)
                        with torch.no_grad():
                            if aa_tex_plan is None or aa_tex_plan.n_split <= 1:
                                m = _edge_band_tile_mask(p0, p1, sigma, flat, grid, height, width)
                            else:
                                sel = flat.nonzero().squeeze(1)
                                zeros = torch.zeros((sel.shape[0], 2), dtype=pts.dtype, device=pts.device)
                                edges = EdgeData(v0=pts[i0[sel]], v1=pts[i1[sel]], z=zeros, attrs=zeros[..., None],
                                                 uvs=torch.stack([uv[j0[sel]], uv[j1[sel]]], dim=1), shades=zeros,
                                                 active=torch.ones_like(sel, dtype=torch.bool),
                                                 use_texture=torch.ones_like(sel, dtype=torch.bool))
                                seg = split_edges(edges, aa_tex_plan.n_split, None,
                                                  uv_segment_length=aa_tex_plan.uv_segment_length)
                                m = _edge_band_tile_mask(seg.v0, seg.v1, sigma, seg.active, grid, height, width)
                            return int(m.sum(dim=1).max()) if m.numel() else 0
            if want_tiling:
                tri = pts[faces]  # (F, 3, 2)
                u_e, w_e = tri[:, 1, :] - tri[:, 0, :], tri[:, 2, :] - tri[:, 0, :]
                raw = 0.5 * (u_e[:, 0] * w_e[:, 1] - w_e[:, 0] * u_e[:, 1])
                area = raw if mesh.clockwise else -raw
                drawn = (depths[faces] >= 0).all(dim=1)
                if backface_culling:
                    drawn = drawn & (area > 0)
                x_lo = torch.floor(tri[:, :, 0].amin(dim=1)).clamp(0, width - 1)
                x_hi = torch.floor(tri[:, :, 0].amax(dim=1)).clamp(0, width - 1)
                y_lo = torch.floor(tri[:, :, 1].amin(dim=1)).clamp(0, height - 1)
                y_hi = torch.floor(tri[:, :, 1].amax(dim=1)).clamp(0, height - 1)
                st["med_h"] = torch.quantile(tri[:, :, 1].amax(dim=1) - tri[:, :, 1].amin(dim=1), 0.5)
                n_tx = -(-width // _TILE_W)
                for th in _tile_heights(height):
                    n_ty = -(-height // th)
                    counts = _occupancy_counts(x_lo, x_hi, y_lo, y_hi, drawn, n_ty, n_tx, th, _TILE_W)
                    st[f"tri_occ_{th}"] = counts.max()
                    st[f"super_occ_{th}"] = _occupancy_counts(
                        x_lo, x_hi, y_lo, y_hi, drawn, -(-n_ty // _SUPER_TY), -(-n_tx // _SUPER_TX),
                        th * _SUPER_TY, _TILE_W * _SUPER_TX,
                    ).max()
                    sy = torch.floor(y_hi / th) - torch.floor(y_lo / th) + 1
                    st[f"span_tiles_y_{th}"] = torch.where(drawn, sy, 0.0).max()
                if sigma > 0 and mesh.texture is None:
                    # the edge-pass cost model's candidates
                    for th in _edge_tile_heights(height):
                        m = _edge_band_tile_mask(p0, p1, sigma, flat, _grid(height, width, th, _TILE_W), height, width)
                        st[f"edge_occ_{th}"] = m.sum(dim=1).max()
                        st[f"edge_sum_{th}"] = m.sum()
                st["n_drawn"] = drawn.sum()
                if mesh.texture is not None:
                    # occupied 8-row fetch blocks, at the tile width and the narrower candidates
                    for bw in (_TILE_W,) + _TEX_BW_CANDIDATES:
                        cb = _occupancy_counts(x_lo, x_hi, y_lo, y_hi, drawn, -(-height // 8), -(-width // bw), 8, bw)
                        st[f"tex_blocks_{bw}"] = (cb > 0).sum()
                sx = torch.floor(x_hi / _TILE_W) - torch.floor(x_lo / _TILE_W) + 1
                st["span_tiles_x"] = torch.where(drawn, sx, 0.0).max()
            values = torch.stack([v.to(torch.float32) for v in st.values()]).cpu().numpy() if st else []
        return dict(zip(st, values)), band_count

    def _eager_plan(self, camera: Camera, backface_culling: bool = True):
        """The static render plan of this view → (aa_edge_capacity, tiling,
        aa_window, aa_tex_window, aa_tex_plan), with the rules of the JAX
        planner for its kernel route (``impl="pallas"``): capacities from
        measured bin occupancies with margins and buckets, the solid and
        edge tile heights, the drawn-triangle compaction, the texture-fetch
        block width and capacity, the quad fetch's fallback capacity, the
        pair or supertile binning decision and the textured edge pass's
        split plan, kept from the last plan of the same view while that
        still fits and is at most 4× too large (hysteresis: bucketed sizes
        would otherwise flip between neighbouring powers of two).

        Two differences. A textured plan with split edges sizes
        ``edge_capacity`` from the split segments' bands, which the
        textured edge pass bins (the JAX planner counts whole edges, and
        its capacity can overflow). A textured plan at σ > 0 always gets
        an :class:`EdgeTexPlan` (the JAX planner drops it when its TPU
        texture windows would not fit in fast memory). The ``DEODR_TILE_H``,
        ``DEODR_EDGE_TILE_H`` and ``DEODR_TEX_BW`` tuning overrides are not
        read."""
        mesh = self.mesh
        height, width = camera.height, camera.width
        sigma = float(self.sigma)
        want_tiling = mesh.nb_faces > 256 and self.impl != "brute"
        tile_w = _TILE_W
        quad_fetch = bool(os.environ.get("DEODR_QUAD_FETCH")) if self.quad_fetch is None else bool(self.quad_fetch)
        stats, band_count = self._plan_statistics(camera, backface_culling, want_tiling)
        n_flags = int(stats["n_flags"]) if sigma > 0 else 0

        cap = aa_window = aa_tex_window = None
        if sigma > 0:
            # multiple-of-64 rounding with margin
            cap = min(3 * mesh.nb_faces, max(64, -(-int(n_flags * 1.25) // 64) * 64))
            if n_flags > 0:
                # windows bounding the largest band (sequential edge pass only)
                aa_window = edge_window(float(stats["span_y"]), float(stats["span_x"]), sigma, height, width)
                if mesh.texture is not None and mesh.uv is not None:
                    th_t, tw_t = mesh.texture.shape[0], mesh.texture.shape[1]
                    twh = min(_pow2(max(int(stats["uspan_v"] + 4), 8), 1), th_t)
                    tww = min(_pow2(max(int(stats["uspan_u"] + 4), 128), 1), tw_t)
                    if (twh, tww) != (th_t, tw_t):
                        aa_tex_window = (twh, tww)

        last = self._last_plan.get(self._plan_key(camera, sigma, want_tiling, backface_culling, quad_fetch))
        aa_tex_plan = None
        if sigma > 0 and n_flags > 0 and want_tiling and mesh.texture is not None and mesh.uv is not None:
            span = float(max(stats["uspan_v"], stats["uspan_u"]))
            if span <= 12.0:
                n_split, seg_cap = 1, 0
            else:
                # ~6-texel segments (deodr_tpu/scene.py:878-886); n_seg12 counted 12-texel ones
                n_split = _pow2(np.ceil(span / 6.0), 2)
                seg_cap = max(64, -(-int(float(stats["n_seg12"]) * 2.0 * 1.2) // 64) * 64)
            aa_tex_plan = EdgeTexPlan(n_split=n_split, seg_capacity=seg_cap, uv_segment_length=6.0 if seg_cap else 12.0)
            l_plan = None if last is None else last[4]
            if (
                l_plan is not None
                and aa_tex_plan.n_split <= l_plan.n_split <= 4 * max(aa_tex_plan.n_split, 1)
                and (aa_tex_plan.seg_capacity <= l_plan.seg_capacity <= 4 * max(aa_tex_plan.seg_capacity, 8)
                     or (aa_tex_plan.seg_capacity == 0 and l_plan.seg_capacity == 0))
            ):
                aa_tex_plan = l_plan

        tiling = None
        if want_tiling:
            short, tall = _tile_heights(height)
            tile_h = short if float(stats["med_h"]) <= 32 else tall
            tri_cap = int(stats[f"tri_occ_{tile_h}"])
            # edge tile height: 8 rows for textured scenes under taller solid
            # tiles; untextured scenes pick it by the edge-pass cost model
            edge_tile_h = 8 if tile_h > 8 else 0
            if sigma > 0 and mesh.texture is None and n_flags > 0:
                def edge_cost(th):
                    return float(stats[f"edge_sum_{th}"]) * (_F_VISIT + th * tile_w * _C_PX)

                best_e = min(_edge_tile_heights(height), key=edge_cost)
                edge_tile_h = 0 if best_e == tile_h else best_e
            if sigma <= 0:
                edge_cap = 8
            elif band_count is not None:
                # the textured edge pass bins the split segments, where the plan splits edges
                edge_cap = band_count(edge_tile_h or tile_h, aa_tex_plan)
            else:
                edge_cap = int(stats[f"edge_occ_{edge_tile_h or tile_h}"])
            n_drawn = int(stats["n_drawn"])
            n_tiles_sel = (-(-height // tile_h)) * (-(-width // tile_w))
            super_occ_sel = int(stats[f"super_occ_{tile_h}"])
            tex_tile_cap = tex_block_w = occ_bw = quad_fallback_cap = 0
            if mesh.texture is not None:
                # 8-row fetch blocks: the narrowest width with the fewest
                # fetched pixels, fatter rows on ties; capacity = the
                # occupied blocks (bbox occupancy bounds the fetch's
                # flag-based count) rounded up to 8
                cands = [(bw, int(stats[f"tex_blocks_{bw}"])) for bw in (tile_w,) + _TEX_BW_CANDIDATES]
                tex_bw, occ_bw = min(cands, key=lambda c: (c[0] * c[1], -c[0]))
                n_blocks_bw = (-(-height // 8)) * (-(-width // tex_bw))
                tex_tile_cap = min(max(8, -(-occ_bw // 8) * 8), n_blocks_bw)
                tex_block_w = 0 if tex_bw == tile_w else tex_bw
                tex_hw = mesh.texture.shape[:2]
                if quad_fetch and tile_h % 2 == 0 and tex_hw[0] % 2 == 0 and tex_hw[1] % 2 == 0 and min(tex_hw) >= 8:
                    n_quads = tex_tile_cap * (8 // 2) * ((tex_block_w or tile_w) // 2)
                    need = -(-n_quads // 24)
                    quad_fallback_cap = min(n_quads, max(512, -(-need // 256) * 256))
            # large-mesh binning: pair expansion when every drawn bbox spans
            # few tiles, else supertiles once the dense mask would be large
            pair_ry = pair_rx = super_ty = super_tx = super_capacity = 0
            span_y_sel = int(stats[f"span_tiles_y_{tile_h}"])
            span_x_sel = int(stats["span_tiles_x"])
            if n_drawn >= 8192 and span_y_sel > 0 and span_y_sel * span_x_sel <= 8:
                pair_ry, pair_rx = span_y_sel, span_x_sel
            elif n_tiles_sel * max(n_drawn, 1) > (1 << 22):
                super_ty, super_tx = _SUPER_TY, _SUPER_TX
                super_capacity = _bucket(max(super_occ_sel, 8))
            tiling = TilingConfig(
                tile_h=tile_h, tile_w=tile_w, triangle_capacity=_bucket(tri_cap), edge_capacity=_bucket(edge_cap),
                # multiple-of-256 rounding: a power of two would round a half-culled mesh back up to its size
                drawn_capacity=min(-(-int(n_drawn * 1.2) // 256) * 256, mesh.nb_faces), edge_tile_h=edge_tile_h,
                tex_tile_capacity=tex_tile_cap, quad_fallback_capacity=quad_fallback_cap, tex_block_w=tex_block_w,
                super_ty=super_ty, super_tx=super_tx, super_capacity=super_capacity, pair_ry=pair_ry, pair_rx=pair_rx,
            )
            l_tiling = None if last is None else last[1]
            if l_tiling is not None and self._tiling_still_fits(
                    tiling, l_tiling, tri_cap, edge_cap, n_drawn, occ_bw, super_occ_sel, span_y_sel, span_x_sel):
                tiling = l_tiling

        if last is not None:
            l_cap, _, l_win, l_texwin, _ = last
            if cap is not None and l_cap is not None and n_flags <= l_cap <= 4 * max(cap, 8):
                cap = l_cap
            if (aa_window is not None and l_win is not None and aa_window[0] <= l_win[0] <= 4 * aa_window[0]
                    and aa_window[1] <= l_win[1] <= 4 * aa_window[1] and l_win[0] <= height and l_win[1] <= width):
                aa_window = l_win
            if (aa_tex_window is not None and l_texwin is not None
                    and aa_tex_window[0] <= l_texwin[0] <= 4 * aa_tex_window[0]
                    and aa_tex_window[1] <= l_texwin[1] <= 4 * aa_tex_window[1]):
                aa_tex_window = l_texwin
        plan = (cap, tiling, aa_window, aa_tex_window, aa_tex_plan)
        key = self._plan_key(camera, sigma, want_tiling, backface_culling, quad_fetch)
        self._last_plan[key] = plan
        self._last_plan.move_to_end(key)
        while len(self._last_plan) > _PLAN_CACHE_MAX:
            self._last_plan.popitem(last=False)
        return plan

    def _plan_key(self, camera, sigma, want_tiling, backface_culling, quad_fetch):
        """The facts a plan is kept for: the image size and distortion, the
        mesh and its sizes, σ, and the switches of the plan."""
        mesh = self.mesh
        return (camera.height, camera.width, camera.distortion is None, id(mesh), mesh.nb_vertices, mesh.nb_faces,
                sigma, want_tiling, backface_culling, quad_fetch)

    @staticmethod
    def _tiling_still_fits(tiling, last, tri_cap, edge_cap, n_drawn, occ_bw, super_occ, span_y, span_x) -> bool:
        """Is the last tiling still fit for these counts: same tile shapes,
        every capacity holds its count and is at most 4× the fresh one?"""
        def within(count, old, new):
            return count <= old <= 4 * max(new, 8)

        return (
            (last.tile_h, last.tile_w, last.edge_tile_h) == (tiling.tile_h, tiling.tile_w, tiling.edge_tile_h)
            and tri_cap <= last.triangle_capacity <= 4 * tiling.triangle_capacity
            and edge_cap <= last.edge_capacity <= 4 * tiling.edge_capacity
            and ((tiling.drawn_capacity == 0 and last.drawn_capacity == 0)
                 or within(n_drawn, last.drawn_capacity, tiling.drawn_capacity))
            and ((tiling.tex_tile_capacity == 0 and last.tex_tile_capacity == 0)
                 or (tiling.tex_tile_capacity > 0 and last.tex_block_w == tiling.tex_block_w
                     and within(occ_bw, last.tex_tile_capacity, tiling.tex_tile_capacity)))
            and ((tiling.super_capacity == 0 and last.super_capacity == 0)
                 or ((tiling.super_ty, tiling.super_tx) == (last.super_ty, last.super_tx)
                     and within(super_occ, last.super_capacity, tiling.super_capacity)))
            and ((tiling.pair_ry == 0 and last.pair_ry == 0)
                 or (tiling.pair_ry > 0 and span_y <= last.pair_ry <= span_y + 2
                     and span_x <= last.pair_rx <= span_x + 2))
        )
