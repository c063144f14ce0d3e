"""Full scene rendering: solid pass + silhouette edge-overdraw pass.

PyTorch counterpart of ``deodr_tpu/ops/render.py``, tiled branch: one
function, differentiable by autograd with respect to the vertex positions
(``ij``), the per-vertex colors and the background. It renders untextured,
not perspective-correct scenes with ``strict_edge``; the other modes belong
to later parts of the port and raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from deodr_tpu_torch.ops.common import sum3
from deodr_tpu_torch.ops.edge_aa import EdgeAAConfig, EdgeData
from deodr_tpu_torch.ops.tiled import TilingConfig, _compact_index_perm, edge_pass_tiled_kernel, rasterize_tiled_kernel


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


def _refuse_off_slice(scene: SceneBuffers, tiling, aa_window, aa_tex_window, aa_tex_plan):
    if tiling is None:
        raise NotImplementedError("the untiled path (tiling=None) comes with the untiled-renderer slice")
    if scene.texture is not None:
        raise NotImplementedError("textured rendering comes with the textured slice (edge_tex_kernel)")
    if scene.perspective_correct:
        raise NotImplementedError("perspective-correct interpolation comes with the textured slice")
    if not scene.strict_edge:
        raise NotImplementedError("strict_edge=False comes with the untiled-renderer slice")
    if aa_window is not None or aa_tex_window is not None or aa_tex_plan is not None:
        raise NotImplementedError("aa_window / aa_tex_window / aa_tex_plan come with the textured slice")


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
    aa_tex_plan=None,
    check_capacity: bool = False,
):
    """Render a 2.5D scene on the scene tensors' device.

    Returns (image (H, W, C), z_buffer (H, W), err_buffer (H, W) or None);
    ``err_buffer`` is the antialiased squared residual against ``obs`` when
    ``antialiase_error``. ``impl="kernel"`` runs the CUDA kernels on a CUDA
    scene (a CPU scene always takes their plain versions);
    ``impl="reference"`` takes the plain versions on any device.

    Bins that overflow a capacity of ``tiling`` (or ``aa_edge_capacity``)
    drop entries silently, as in the JAX package; ``check_capacity=True``
    raises ``RuntimeError`` naming the bin instead, at the cost of a host
    synchronisation per check.
    """
    _refuse_off_slice(scene, tiling, aa_window, aa_tex_window, aa_tex_plan)
    checks: Optional[list] = [] if check_capacity else None
    ij_off, signed_area_v, draw, background = prepare(scene)

    image, z_buffer, solid_max = rasterize_tiled_kernel(scene, ij_off, draw, background, tiling, impl, checks)
    if checks is not None:
        checks.append(("solid tile bin", solid_max, tiling.triangle_capacity))
    z_buffer = z_buffer.detach()

    err_buffer = None
    if antialiase_error:
        if obs is None:
            raise ValueError("antialiase_error needs obs")
        err_buffer = ((image - obs) ** 2).sum(dim=-1)

    if sigma > 0:
        edges = _build_edge_data(scene, ij_off, signed_area_v, aa_edge_capacity, checks)
        cfg = EdgeAAConfig(scene.height, scene.width, float(sigma), bool(scene.clockwise), bool(antialiase_error))
        if antialiase_error:
            err_buffer, edge_max = edge_pass_tiled_kernel(cfg, err_buffer, edges, z_buffer, obs, tiling, impl)
        else:
            image, edge_max = edge_pass_tiled_kernel(cfg, image, edges, z_buffer, None, tiling, impl)
        if checks is not None:
            checks.append(("edge tile bin", edge_max, tiling.edge_capacity))

    for label, count, capacity in checks or ():
        count = int(count)
        if count > capacity:
            raise RuntimeError(
                f"{label} overflow: occupancy {count} exceeds static capacity {capacity}; entries were "
                "dropped — raise the capacity in TilingConfig / aa_edge_capacity (see suggest_tiling)"
            )
    return image, z_buffer, err_buffer


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
    many slots."""
    nt = scene.faces.shape[0]
    dev = ij_off.device
    sum_depth = sum3(scene.depths[scene.faces], dim=1)
    order = torch.sort(sum_depth, descending=True, stable=True).indices
    faces_o = scene.faces[order]  # (T, 3)
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
    return EdgeData(
        v0=ij_off[i0],
        v1=ij_off[i1],
        z=torch.stack([scene.depths[i0], scene.depths[i1]], dim=1),
        attrs=torch.stack([scene.colors[i0], scene.colors[i1]], dim=1),
        active=active,
    )
