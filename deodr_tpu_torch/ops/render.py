"""Full scene rendering: solid pass + silhouette edge-overdraw pass.

PyTorch counterpart of ``deodr_tpu/ops/render.py``: one function,
differentiable by autograd with respect to the vertex positions (``ij``),
the depths (through perspective-correct interpolation), the per-vertex
colors, the texture coordinates (``uv``), the Gouraud ``shade``, the
``texture`` and the background, for untextured, textured and mixed scenes,
tiled or not, with or without ``strict_edge`` and perspective correction;
and ``validate_capacities``, the binning-only check of a plan's capacities.
Only the large-mesh binners (``pair_*`` and ``super_*`` tilings) belong to a
later part of the port and raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from deodr_tpu_torch.ops.common import sum3
from deodr_tpu_torch.ops.edge_aa import EdgeAAConfig, EdgeData, edge_overdraw_pass
from deodr_tpu_torch.ops.raster import find_winners, shade_pixels, triangle_row_setup
from deodr_tpu_torch.ops.tiled import (
    EdgeTexPlan,
    TilingConfig,
    _compact_index_perm,
    _edge_band_tile_mask,
    _grid,
    _occupancy_counts,
    edge_pass_tiled_kernel,
    edge_pass_tiled_kernel_tex,
    rasterize_tiled_kernel,
)


@dataclasses.dataclass
class SceneBuffers:
    """The 2.5D scene record handed to the rasterizer, with the field names
    of the JAX package's ``SceneBuffers``. ``ij[:, 0]`` is the x (column)
    and ``ij[:, 1]`` the y (row) coordinate of each projected vertex."""

    faces: torch.Tensor  # (T, 3) int64
    faces_uv: torch.Tensor  # (T, 3) int64
    ij: torch.Tensor  # (V, 2)
    depths: torch.Tensor  # (V,)
    uv: torch.Tensor  # (Vuv, 2)
    shade: torch.Tensor  # (V,)
    colors: torch.Tensor  # (V, C)
    edgeflags: torch.Tensor  # (T, 3) bool
    textured: torch.Tensor  # (T,) bool
    shaded: torch.Tensor  # (T,) bool
    texture: Optional[torch.Tensor]  # (th, tw, C) or None
    background_image: Optional[torch.Tensor]  # (H, W, C) or None
    background_color: Optional[torch.Tensor]  # (C,) or None
    height: int = 0
    width: int = 0
    clockwise: bool = False
    backface_culling: bool = True
    strict_edge: bool = True
    perspective_correct: bool = False
    integer_pixel_centers: bool = True


_META = ("height", "width", "clockwise", "backface_culling", "strict_edge", "perspective_correct",
         "integer_pixel_centers")


def scene_buffers_from_numpy(fields: dict, device=None, dtype=None) -> SceneBuffers:
    """A :class:`SceneBuffers` from numpy arrays under the JAX
    ``SceneBuffers`` field names (as ``np.asarray`` gives them) plus its
    meta fields. Float arrays are cast to ``dtype`` when given, integer
    arrays become int64 and booleans stay boolean. ``device`` defaults to
    ``cuda``, and asking for CUDA where there is none raises: the port
    never falls back to the CPU by itself."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA was requested but torch.cuda.is_available() is False; pass device='cpu'")
    kwargs = {}
    for f in dataclasses.fields(SceneBuffers):
        value = fields.get(f.name)
        if f.name in _META:
            if value is not None:
                kwargs[f.name] = type(f.default)(value)
            continue
        if value is None:
            kwargs[f.name] = None
            continue
        a = np.asarray(value)
        if a.dtype == np.bool_:
            t = torch.from_numpy(a.copy())
        elif np.issubdtype(a.dtype, np.integer):
            t = torch.from_numpy(a.astype(np.int64))
        else:
            t = torch.from_numpy(a.copy())
            if dtype is not None:
                t = t.to(dtype)
        kwargs[f.name] = t.to(device)
    return SceneBuffers(**kwargs)


def _culling(scene: SceneBuffers) -> torch.Tensor:
    """Per-triangle signed area, zero for triangles behind the camera."""
    v_xy = scene.ij[scene.faces]
    frontal = (scene.depths[scene.faces] >= 0).all(dim=1)
    u = v_xy[:, 1, :] - v_xy[:, 0, :]
    w = v_xy[:, 2, :] - v_xy[:, 0, :]
    raw = 0.5 * (u[:, 0] * w[:, 1] - w[:, 0] * u[:, 1])
    area = raw if scene.clockwise else -raw
    return torch.where(frontal, area, 0.0)


def prepare(scene: SceneBuffers):
    """Shared preamble of a render → (ij_off, signed_area, draw, background)."""
    offset = 0.0 if scene.integer_pixel_centers else 0.5
    ij_off = scene.ij - offset
    signed_area_v = _culling(scene)
    draw = signed_area_v > 0
    if not scene.backface_culling:
        draw = torch.ones_like(draw)
    # textured-but-unshaded triangles are skipped entirely
    draw = draw & (~scene.textured | scene.shaded)
    if scene.background_image is not None:
        background = scene.background_image
    else:
        background = scene.background_color.expand(scene.height, scene.width, scene.colors.shape[1])
    return ij_off, signed_area_v, draw, background


def render_scene(
    scene: SceneBuffers,
    sigma: float,
    antialiase_error: bool = False,
    obs: Optional[torch.Tensor] = None,
    aa_edge_capacity: Optional[int] = None,
    tiling: Optional[TilingConfig] = None,
    impl: str = "kernel",
    aa_window: Optional[tuple] = None,
    aa_tex_window: Optional[tuple] = None,
    aa_tex_plan: Optional[EdgeTexPlan] = None,
    check_capacity: bool = False,
    chunk: int = 64,
):
    """Render a 2.5D scene on the scene tensors' device.

    Returns (image (H, W, C), z_buffer (H, W), err_buffer (H, W) or None);
    ``err_buffer`` is the antialiased squared residual against ``obs`` when
    ``antialiase_error``. The routes are the JAX package's:

    - the solid pass: with ``tiling``, binned and resolved by the raster
      kernel (``impl="kernel"`` runs the CUDA kernels on a CUDA scene; a CPU
      scene, or ``impl="reference"``, takes their plain versions); without,
      the untiled pass (``find_winners`` over chunks of ``chunk``
      triangles, then ``shade_pixels``);
    - the edge pass at ``sigma > 0``: the tiled edge kernel for an
      untextured scene, the tiled textured edge kernel for a textured one
      with ``aa_tex_plan`` (its bands split and compacted as the plan
      says), both only for a tiling and without perspective correction;
      everything else takes the sequential pass
      (:func:`deodr_tpu_torch.ops.edge_aa.edge_overdraw_pass`), restricted
      to ``aa_window``-shaped windows when given. (The JAX package sends an
      untextured perspective-correct tiled scene to its XLA tiled pass,
      which matches its sequential pass.) ``aa_tex_window`` bounds the
      texels of the JAX package's windowed pass on a TPU; here every texel
      is read where it lies, so it changes nothing.

    Bins that overflow a capacity of ``tiling`` (or ``aa_edge_capacity``, or
    the plan's ``seg_capacity``; the texture fetch's ``tex_tile_capacity``
    and ``quad_fallback_capacity``) drop entries silently, as in the JAX package; ``check_capacity=True``
    raises ``RuntimeError`` naming the bin instead, at the cost of a host
    synchronisation per check.
    """
    if scene.texture is not None and scene.texture.shape[2] != scene.colors.shape[1]:
        raise ValueError("texture and colors must have the same number of channels")
    checks: Optional[list] = [] if check_capacity else None
    ij_off, signed_area_v, draw, background = prepare(scene)
    persp = scene.perspective_correct

    if tiling is not None:
        image, z_buffer, solid_max = rasterize_tiled_kernel(scene, ij_off, draw, background, tiling, impl, checks)
        if checks is not None:
            checks.append(("solid tile bin", solid_max, tiling.triangle_capacity))
    else:
        faces = scene.faces
        winner, z_buffer = find_winners(ij_off[faces], scene.depths[faces], draw, scene.width, scene.height,
                                        scene.strict_edge, persp, chunk)
        image = shade_pixels(winner, ij_off, scene.depths, faces, scene.faces_uv, scene.colors, scene.uv,
                             scene.shade, scene.textured, scene.shaded, scene.texture, background, persp)
    z_buffer = z_buffer.detach()

    err_buffer = None
    if antialiase_error:
        if obs is None:
            raise ValueError("antialiase_error needs obs")
        err_buffer = ((image - obs) ** 2).sum(dim=-1)

    if sigma > 0:
        edges = _build_edge_data(scene, ij_off, signed_area_v, aa_edge_capacity, checks)
        cfg = EdgeAAConfig(scene.height, scene.width, float(sigma), bool(scene.clockwise), bool(antialiase_error),
                           scene.texture is not None, persp)
        buffer = err_buffer if antialiase_error else image
        edge_max = None
        if tiling is not None and not persp and cfg.has_texture and aa_tex_plan is not None:
            buffer, edge_max = edge_pass_tiled_kernel_tex(
                cfg, buffer, edges, scene.texture, z_buffer, obs, tiling, aa_tex_plan, impl, checks
            )
        elif tiling is not None and not persp and not cfg.has_texture:
            buffer, edge_max = edge_pass_tiled_kernel(cfg, buffer, edges, z_buffer, obs, tiling, impl)
        else:
            buffer = edge_overdraw_pass(cfg, buffer, edges, scene.texture, z_buffer, obs, aa_window)
        if antialiase_error:
            err_buffer = buffer
        else:
            image = buffer
        if checks is not None and edge_max is not None:
            checks.append(("edge tile bin", edge_max, tiling.edge_capacity))

    _raise_overflows(checks or ())
    return image, z_buffer, err_buffer


def _raise_overflows(checks) -> None:
    """Raise ``RuntimeError`` for the first (label, count, capacity) whose
    count exceeds its capacity (one host read per check)."""
    for label, count, capacity in checks:
        count = int(count)
        if count > capacity:
            raise RuntimeError(
                f"{label} overflow: occupancy {count} exceeds static capacity {capacity}; entries were "
                "dropped — raise the capacity in TilingConfig / aa_edge_capacity / the plan (see suggest_tiling)"
            )


# the capacity classes of validate_capacities, in the order of its ``caps``
CAPACITY_CLASSES = (
    "AA edge compaction", "solid tile bin", "edge tile bin", "supertile bin", "drawn-triangle compaction",
    "texture tile compaction", "texture-window segment compaction",
)


def validate_capacities(scene: SceneBuffers, sigma: float, caps, tile_h: int, tile_w: int, edge_tile_h: int = 0,
                        super_shape=(0, 0), tex_block_w: int = 0, uv_segment_length: float = 0.0,
                        uv_n_split: int = 1, raise_on_overflow: bool = True):
    """The bin and compaction counts of a render, from the binning alone
    (no per-pixel work), held against ``caps`` → (counts, ok): ``counts`` a
    dict of :data:`CAPACITY_CLASSES` to int, ``ok`` whether each count is
    within its capacity. With ``raise_on_overflow`` an overflow raises
    ``RuntimeError`` naming the class instead, as ``render_scene(...,
    check_capacity=True)`` does. Counterpart of the JAX package's
    ``validate_capacities``, which asserts the same counts with checkify.

    ``caps`` lists the capacities in the order of :data:`CAPACITY_CLASSES`
    (five entries skip the two texture classes; a huge value skips a
    class). The counts are the JAX package's: per-tile bounding-box
    overlaps of the drawn triangles (the dense binner's counts; the
    supertile count at ``super_shape`` tiles), band-vs-tile overlaps of the
    active silhouette edges at ``edge_tile_h`` (or ``tile_h``) rows without
    the occlusion cull (an upper bound of the rendered count), the active
    edges, the drawn triangles, the 8 × ``tex_block_w`` texture-fetch blocks
    a drawn bounding box overlaps, and the textured pass's segments of the
    active edges (at ``uv_segment_length`` texels, at most ``uv_n_split``
    an edge)."""
    caps = [int(c) for c in caps] + [1 << 30] * (len(CAPACITY_CLASSES) - len(caps))
    height, width = scene.height, scene.width
    dev = scene.ij.device
    with torch.no_grad():
        ij_off, signed_area_v, draw, _ = prepare(scene)
        setup = triangle_row_setup(ij_off[scene.faces], scene.depths[scene.faces], draw, width, height,
                                   scene.strict_edge, scene.perspective_correct)
        x_lo, x_hi, y_lo, y_hi = setup.x_lo, setup.x_hi, setup.y_lo[:, 0], setup.y_hi[:, 1]

        def tile_counts(th, tw):
            """Per-tile bounding-box overlap counts, (n_ty, n_tx)."""
            ok = setup.valid & (x_lo <= x_hi) & (y_lo <= y_hi)
            return _occupancy_counts(x_lo, x_hi, y_lo, y_hi, ok, -(-height // th), -(-width // tw), th, tw)

        zero = torch.zeros((), dtype=torch.int64, device=dev)
        active = scene.edgeflags & (signed_area_v > 0)[:, None]
        counts = {"AA edge compaction": active.sum(), "solid tile bin": tile_counts(tile_h, tile_w).max(),
                  "edge tile bin": zero, "supertile bin": zero, "drawn-triangle compaction": draw.sum(),
                  "texture tile compaction": zero, "texture-window segment compaction": zero}
        s_ty, s_tx = super_shape
        if s_ty and s_tx:
            counts["supertile bin"] = tile_counts(tile_h * s_ty, tile_w * s_tx).max()
        if sigma > 0:
            faces = scene.faces
            v0 = ij_off[faces[:, [1, 2, 0]].reshape(-1)]
            v1 = ij_off[faces[:, [0, 1, 2]].reshape(-1)]
            grid = _grid(height, width, edge_tile_h or tile_h, tile_w)
            mask = _edge_band_tile_mask(v0, v1, float(sigma), active.reshape(-1), grid, height, width)
            counts["edge tile bin"] = mask.sum(dim=1).max()
        if scene.texture is not None and tex_block_w > 0:
            counts["texture tile compaction"] = (tile_counts(8, tex_block_w) > 0).sum()
        if scene.texture is not None and sigma > 0 and uv_segment_length > 0:
            fuv = scene.faces_uv
            span = (scene.uv[fuv[:, [1, 2, 0]].reshape(-1)] - scene.uv[fuv[:, [0, 1, 2]].reshape(-1)]).abs().amax(dim=1)
            need = torch.clamp_min(span / uv_segment_length, 1.0)
            n_seg = torch.nan_to_num(need, nan=1.0, posinf=float(uv_n_split)).ceil().clamp(1, uv_n_split)
            counts["texture-window segment compaction"] = torch.where(active.reshape(-1), n_seg, 0.0).sum()
        values = torch.stack([counts[k].to(torch.int64) for k in CAPACITY_CLASSES]).tolist()  # one host read
    counts = dict(zip(CAPACITY_CLASSES, values))
    if raise_on_overflow:
        _raise_overflows((k, counts[k], c) for k, c in zip(CAPACITY_CLASSES, caps))
    return counts, all(counts[k] <= c for k, c in zip(CAPACITY_CLASSES, caps))


def _build_edge_data(
    scene: SceneBuffers,
    ij_off: torch.Tensor,
    signed_area_v: torch.Tensor,
    aa_edge_capacity: Optional[int] = None,
    checks: Optional[list] = None,
) -> EdgeData:
    """Per-edge tensors in back-to-front order: triangles sorted by
    descending depth sum (ties keep the lower index first), edge slots
    0..2 of each using vertex pairs (1,0), (2,1), (0,2). Only edges flagged
    in ``edgeflags`` of front-facing triangles are active; with
    ``aa_edge_capacity`` the active edges are compacted, in order, to that
    many slots. ``uvs`` are zero for a scene without a texture;
    ``use_texture`` marks the edges of textured and shaded triangles."""
    nt = scene.faces.shape[0]
    dev = ij_off.device
    sum_depth = sum3(scene.depths[scene.faces], dim=1)
    order = torch.sort(sum_depth, descending=True, stable=True).indices
    faces_o = scene.faces[order]  # (T, 3)
    faces_uv_o = scene.faces_uv[order]
    use_texture_o = (scene.textured & scene.shaded)[order]
    active = (scene.edgeflags[order] & (signed_area_v[order] > 0)[:, None]).reshape(-1)  # (3T,)
    idx = torch.arange(3 * nt, device=dev)
    if aa_edge_capacity is not None and aa_edge_capacity < 3 * nt:
        if checks is not None:
            checks.append(("AA edge compaction", active.sum(), aa_edge_capacity))
        idx, got = _compact_index_perm(active, aa_edge_capacity)
        active = active[idx] & got
    tri, slot = idx // 3, idx % 3
    i0 = faces_o[tri, (slot + 1) % 3]
    i1 = faces_o[tri, slot]
    if scene.texture is not None and scene.uv.shape[0] > 0:
        uvs = torch.stack([scene.uv[faces_uv_o[tri, (slot + 1) % 3]], scene.uv[faces_uv_o[tri, slot]]], dim=1)
    else:
        uvs = torch.zeros((idx.shape[0], 2, 2), dtype=ij_off.dtype, device=dev)
    return EdgeData(
        v0=ij_off[i0],
        v1=ij_off[i1],
        z=torch.stack([scene.depths[i0], scene.depths[i1]], dim=1),
        attrs=torch.stack([scene.colors[i0], scene.colors[i1]], dim=1),
        uvs=uvs,
        shades=torch.stack([scene.shade[i0], scene.shade[i1]], dim=1),
        active=active,
        use_texture=use_texture_o[tri],
    )
