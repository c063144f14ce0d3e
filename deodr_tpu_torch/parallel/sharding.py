"""Scale-out on ``torch.distributed``: a ("views", "tiles") device mesh,
tile-sharded rendering and view-parallel fitting steps.

PyTorch counterpart of ``deodr_tpu/parallel/sharding.py``. The design is
SPMD: every rank runs the same program (started by ``torchrun`` or by
:func:`deodr_tpu_torch.parallel.launch.run_ranks`), passes the *full*
inputs (the whole scene, the whole view batch) and takes its shard from its
coordinate on the mesh, as ``jax.device_put`` distributes inside the JAX
functions. Two axes:

* **tile parallelism**: the framebuffer's rows are split into bands over
  the ``tiles`` axis. Every per-pixel computation of the renderer is
  row-local, so a rank renders its band alone; the forward gathers the
  bands, and the backward's only collective is one all-reduce of the
  scene fields' gradients.
* **view parallelism**: a batch of views is split over the ``views`` axis;
  each rank differentiates its own views, and the shared parameters'
  gradients and the loss are all-reduced, so every rank ends a step with
  the same parameters.

The collectives that carry gradients have their backward written out here
(:class:`_Replicate`, :class:`_GatherBands`): the backward of
``torch.distributed.nn.functional.all_gather`` sums the cotangents of every
rank, which multiplies the gradient of a loss that each rank computes alike
by the world size. Every collective is recorded in :data:`COLLECTIVES`
(operation, bytes this rank sends, forward or backward), as
``kernels.LAUNCHES`` counts kernel launches. A process group whose backend
is gloo gets CUDA tensors staged through host memory.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional

import torch
import torch.distributed as dist

from deodr_tpu_torch.camera import project_points_arrays
from deodr_tpu_torch.geometry.transforms import normalize, qrot
from deodr_tpu_torch.ops.render import SceneBuffers, render_scene

# the SceneBuffers fields that can carry a gradient
_FLOAT_FIELDS = ("ij", "depths", "uv", "shade", "colors", "texture", "background_image", "background_color")


class Collective(NamedTuple):
    """One collective call: ``op`` ("all_reduce" or "all_gather"), the
    bytes this rank sends (the whole tensor of an all-reduce, the local
    shard of an all-gather), its shape, and whether a backward pass made it."""

    op: str
    nbytes: int
    shape: tuple
    backward: bool


COLLECTIVES: List[Collective] = []


def reset_collectives() -> None:
    COLLECTIVES.clear()


def _host_staged(t: torch.Tensor, group) -> bool:
    return t.device.type != "cpu" and dist.get_backend(group) == "gloo"


def _all_reduce(t: torch.Tensor, group, backward: bool = False) -> torch.Tensor:
    """Sum ``t`` (contiguous) over ``group`` in place; returns it."""
    COLLECTIVES.append(Collective("all_reduce", t.numel() * t.element_size(), tuple(t.shape), backward))
    if _host_staged(t, group):
        host = t.cpu()
        dist.all_reduce(host, group=group)
        t.copy_(host)
    else:
        dist.all_reduce(t, group=group)
    return t


def _all_gather(t: torch.Tensor, group, backward: bool = False) -> torch.Tensor:
    """The ranks' ``t`` concatenated along dim 0, in rank order."""
    COLLECTIVES.append(Collective("all_gather", t.numel() * t.element_size(), tuple(t.shape), backward))
    src = t.detach().contiguous()
    if _host_staged(t, group):
        src = src.cpu()
    out = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, src, group=group)
    return torch.cat(out).to(t.device)


def _all_reduce_flat(tensors, group, backward: bool = False) -> list:
    """Sum every tensor of ``tensors`` (one dtype) over ``group`` with ONE
    all-reduce of their concatenation; returns the sums in their shapes."""
    flat = _all_reduce(torch.cat([t.reshape(-1) for t in tensors]), group, backward)
    return [chunk.view(t.shape) for chunk, t in zip(flat.split([t.numel() for t in tensors]), tensors)]


class _Replicate(torch.autograd.Function):
    """Identity forward; the backward all-reduces the cotangents over the
    group (the transpose of a replicated input, ``in_specs=P()``), one
    all-reduce per dtype."""

    @staticmethod
    def forward(ctx, group, *tensors):
        ctx.group = group
        return tuple(t.view_as(t) for t in tensors)

    @staticmethod
    def backward(ctx, *grads):
        out = list(grads)
        for dtype in dict.fromkeys(g.dtype for g in grads):
            idx = [i for i, g in enumerate(grads) if g.dtype == dtype]
            for i, s in zip(idx, _all_reduce_flat([grads[i].contiguous() for i in idx], ctx.group, True)):
                out[i] = s
        return (None, *out)


class _GatherBands(torch.autograd.Function):
    """All-gather of the ranks' bands along dim 0; the backward returns
    this rank's rows of the cotangent with no communication (the transpose
    of ``out_specs=P("tiles")``)."""

    @staticmethod
    def forward(ctx, band, group, index):
        ctx.rows, ctx.index = band.shape[0], index
        return _all_gather(band, group)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.index * ctx.rows:(ctx.index + 1) * ctx.rows], None, None


def _axis(mesh, name: str):
    """(size, this rank's coordinate, process group) of mesh axis ``name``."""
    group = mesh.get_group(name)
    coord = mesh.get_local_rank(name)
    size = mesh.size(mesh.mesh_dim_names.index(name))
    if dist.get_rank(group) != coord:
        raise RuntimeError(f"the {name!r} group's rank order differs from the mesh coordinates")
    return size, coord, group


def make_device_mesh(n_views: int = 1, n_tiles: Optional[int] = None, device_type: str = "cuda"):
    """A ("views", "tiles") ``DeviceMesh`` over the initialized process
    group's ranks (n_views × n_tiles must be the world size; ``n_tiles``
    defaults to world size // n_views). ``device_type="cpu"`` for a mesh of
    CPU processes (gloo)."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_device_mesh needs an initialized process group (torch.distributed)")
    n = dist.get_world_size()
    if n_tiles is None:
        n_tiles = n // n_views
    if n_views * n_tiles != n:
        raise ValueError(f"{n_views}x{n_tiles} != {n} devices")
    return init_device_mesh(device_type, (n_views, n_tiles), mesh_dim_names=("views", "tiles"))


def make_tile_sharded_render(scene_shape: SceneBuffers, sigma: float, mesh, aa_edge_capacity=None, tiling=None,
                             impl: str = "kernel"):
    """A render function with the framebuffer's rows split into bands over
    the ``tiles`` mesh axis, each rank rendering its band on the production
    route (``tiling`` and ``impl`` as :func:`render_scene` takes them).

    Band ``d`` has ``band_h = ceil(H / n_tiles)`` rows. The rank moves the
    projected vertices up by ``d · band_h`` rows (an integer translation,
    exact for the coordinates near the band) and takes its rows of the
    background image (the last row repeated below the frame). Per-triangle
    setup then rounds the translated coordinates differently, so a band
    matches the same rows of a single-process render to machine epsilon,
    not bitwise: in float32 a pixel within an ulp of an edge may change
    sides.
    The capacities of ``tiling`` and ``aa_edge_capacity`` apply per band (a
    band's occupancies are bounded by the frame's, so a single-process plan
    stays valid).

    Returns ``f(scene) -> (image (H, W, C), z_buffer (H, W))`` on every
    rank: the forward gathers the bands (image and z in one all-gather);
    the backward gives each rank its band's rows of the image cotangent and
    all-reduces the gradients of the scene's differentiable fields once.
    Every rank of the group must call ``f`` and, where gradients are
    taken, the backward, with the same scene.
    """
    n_bands, band, group = _axis(mesh, "tiles")
    height = scene_shape.height
    band_h = -(-height // n_bands)

    def f(scene: SceneBuffers):
        diff = [name for name in _FLOAT_FIELDS
                if isinstance(getattr(scene, name), torch.Tensor) and getattr(scene, name).requires_grad]
        if diff:
            scene = dataclasses.replace(scene, **dict(zip(diff, _Replicate.apply(
                group, *(getattr(scene, name) for name in diff)))))
        off = band * band_h
        ij = scene.ij - scene.ij.new_tensor([0.0, float(off)])
        bg = scene.background_image
        if bg is not None:
            rows = torch.arange(off, off + band_h, device=bg.device).clamp(max=height - 1)
            bg = bg.index_select(0, rows)
        image, z_buffer, _ = render_scene(
            dataclasses.replace(scene, ij=ij, height=band_h, background_image=bg), sigma,
            aa_edge_capacity=aa_edge_capacity, tiling=tiling, impl=impl,
        )
        both = _GatherBands.apply(torch.cat([image, z_buffer[..., None].to(image.dtype)], dim=-1), group, band)
        return both[:height, :, :-1], both[:height, :, -1].detach().to(z_buffer.dtype)

    return f


def shard_render_scene(scene: SceneBuffers, sigma: float, mesh, aa_edge_capacity=None, tiling=None,
                       impl: str = "kernel"):
    """Render one scene with its rows band-sharded over the ``tiles`` axis
    (see :func:`make_tile_sharded_render`) → (image, z_buffer)."""
    return make_tile_sharded_render(scene, sigma, mesh, aa_edge_capacity=aa_edge_capacity, tiling=tiling,
                                    impl=impl)(scene)


def _render_view(vertices, quaternion, translation, mesh_color, light_directional, light_ambient, extrinsic,
                 intrinsic, obs, static):
    """One view's render and its squared-difference data energy.

    ``static`` = (faces (T, 3), edges, edge_faces (E, 2; −1 pads), faces_edges
    (T, 3), degree, height, width, sigma, aa edge capacity,
    background_color (3,)); the index arrays as tensors or numpy, the
    renderer's untiled route as in the JAX package."""
    faces, _, edge_faces, faces_edges, _, height, width, sigma, cap, background_color = static
    device = vertices.device
    faces, edge_faces, faces_edges = (torch.as_tensor(a, device=device).long() for a in (faces, edge_faces, faces_edges))
    vt = qrot(normalize(quaternion), vertices) + translation
    points_2d, depths = project_points_arrays(extrinsic, intrinsic, None, vt)

    # silhouette edges (no gradient) and Lambertian lighting of the vertex normals
    with torch.no_grad():
        tri2 = points_2d[faces]
        u2 = tri2[:, 1] - tri2[:, 0]
        w2 = tri2[:, 2] - tri2[:, 0]
        visible = (u2[:, 0] * w2[:, 1] - w2[:, 0] * u2[:, 1]) < 0
        vis_padded = (edge_faces >= 0) & visible[edge_faces.clamp(min=0)]
        edgeflags = (vis_padded.sum(dim=1) == 1)[faces_edges]
    tri3 = vt[faces]
    fn = torch.linalg.cross(tri3[:, 1] - tri3[:, 0], tri3[:, 2] - tri3[:, 0], dim=1)
    fn = fn / torch.linalg.norm(fn, dim=1, keepdim=True)
    vn = torch.zeros_like(vertices).index_add(0, faces.reshape(-1), fn.repeat_interleave(3, dim=0))
    vn = vn / torch.linalg.norm(vn, dim=1, keepdim=True)
    x = -(vn * light_directional).sum(dim=1)
    lum = 0.5 * (x + x.abs()) + light_ambient  # max(0, x) with jnp.maximum's gradient of 0.5 at a tie
    colors = mesh_color[None, :].expand(vertices.shape[0], -1) * lum[:, None]

    nbv, nbf = vertices.shape[0], faces.shape[0]
    dtype = points_2d.dtype
    buffers = SceneBuffers(
        faces=faces, faces_uv=faces, ij=points_2d, depths=depths,
        uv=torch.zeros((nbv, 2), dtype=dtype, device=device), shade=torch.zeros((nbv,), dtype=dtype, device=device),
        colors=colors, edgeflags=edgeflags, textured=torch.zeros((nbf,), dtype=torch.bool, device=device),
        shaded=torch.zeros((nbf,), dtype=torch.bool, device=device), texture=None, background_image=None,
        background_color=torch.as_tensor(background_color, dtype=dtype, device=device), height=int(height),
        width=int(width),
    )
    image, _, _ = render_scene(buffers, float(sigma), aa_edge_capacity=cap)
    return ((image - obs) ** 2).sum()


_SHARED = ("vertices", "mesh_color", "light_directional", "light_ambient")
_PER_VIEW = ("quaternion", "translation")


def _view_slice(n_items: int, mesh) -> tuple:
    """(this rank's slice of ``n_items`` views, the views axis' group)."""
    n_views, coord, group = _axis(mesh, "views")
    if n_items % n_views:
        raise ValueError(f"{n_items} views do not split over a 'views' axis of {n_views}")
    per = n_items // n_views
    return slice(coord * per, (coord + 1) * per), group


def make_multiview_train_step(static, mesh, lr: float = 1e-6):
    """A multi-view fitting step, view-sharded over the mesh's ``views`` axis.

    Returns ``step(params, obs_batch, extrinsics, intrinsics) -> (params,
    loss)``. params: dict(vertices (V, 3), quaternion (F, 4), translation
    (F, 3), mesh_color (3,), light_directional (3,), light_ambient ());
    obs_batch (F, H, W, 3); extrinsics / intrinsics (F, 3, 4) / (F, 3, 3);
    F a multiple of the ``views`` axis' size. Each rank renders and
    differentiates its F / n views; one all-reduce carries the shared
    parameters' gradients and the loss, one all-gather the per-view pose
    gradients, and every rank takes the same gradient step.
    """

    def step(params, obs_batch, extrinsics, intrinsics):
        own, group = _view_slice(obs_batch.shape[0], mesh)
        leaves = {k: params[k].detach().requires_grad_(True) for k in _SHARED + _PER_VIEW}
        loss = sum(
            _render_view(leaves["vertices"], leaves["quaternion"][i], leaves["translation"][i], leaves["mesh_color"],
                         leaves["light_directional"], leaves["light_ambient"], extrinsics[i], intrinsics[i],
                         obs_batch[i], static)
            for i in range(own.start, own.stop)
        )
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        *shared, loss = _all_reduce_flat([grads[k] for k in _SHARED] + [loss.detach()], group)
        grads.update(zip(_SHARED, shared))
        own_rows = [grads[k][own] for k in _PER_VIEW]
        gathered = _all_gather(torch.cat([g.reshape(g.shape[0], -1) for g in own_rows], dim=1), group)
        grads.update(zip(_PER_VIEW, (gathered[:, :4], gathered[:, 4:])))
        with torch.no_grad():
            new = {k: params[k] - lr * grads[k] for k in params}
        return new, loss

    return step


def multiview_train_step(params, obs_batch, extrinsics, intrinsics, static, mesh, lr: float = 1e-6):
    """One step of :func:`make_multiview_train_step`."""
    return make_multiview_train_step(static, mesh, lr)(params, obs_batch, extrinsics, intrinsics)


_TEX_PARAMS = ("texture", "uv", "shade")


def make_textured_multiview_step(buffers: SceneBuffers, sigma: float, mesh, lr: float = 1e-12,
                                 aa_edge_capacity=None, tiling=None, impl: str = "kernel", aa_window=None,
                                 aa_tex_window=None, aa_tex_plan=None):
    """View-sharded fitting step for textured scenes: the texture atlas, uv
    and shade are shared parameters; the per-view projected vertices and
    observations split over the ``views`` axis.

    params: dict(texture (th, tw, C), uv (N, 2), shade (N,)); ij_batch
    (F, N, 2), obs_batch (F, H, W, C), F a multiple of the ``views`` axis'
    size. Each rank finishes its local backward down to the atlas, uv and
    shade gradients; then ONE all-reduce carries exactly those gradients
    and the loss (for a 512² RGB atlas 3.17 MB a step in float32, where the
    JAX package's jit auto-sharding all-reduced the bilinear footprint
    table's cotangent before the atlas un-build: 16.1 MB, SCALING_r05.json).

    Returns ``step(params, ij_batch, obs_batch) -> (params, loss)``.
    """

    def step(params, ij_batch, obs_batch):
        own, group = _view_slice(ij_batch.shape[0], mesh)
        leaves = [params[k].detach().requires_grad_(True) for k in _TEX_PARAMS]
        loss, grads = 0.0, [torch.zeros_like(p) for p in leaves]
        for ij, obs in zip(ij_batch[own], obs_batch[own]):
            b = dataclasses.replace(buffers, ij=ij, **dict(zip(_TEX_PARAMS, leaves)))
            img, _, _ = render_scene(b, sigma, aa_edge_capacity=aa_edge_capacity, tiling=tiling, impl=impl,
                                     aa_window=aa_window, aa_tex_window=aa_tex_window, aa_tex_plan=aa_tex_plan)
            loss_v = ((img - obs) ** 2).sum()
            d = torch.autograd.grad(loss_v, leaves, allow_unused=True)
            grads = [g if dg is None else g + dg for g, dg in zip(grads, d)]
            loss = loss + loss_v.detach()
        loss = torch.as_tensor(loss, dtype=leaves[0].dtype, device=leaves[0].device)
        *grads, loss = _all_reduce_flat(grads + [loss], group)
        with torch.no_grad():
            new = {k: params[k] - lr * g for k, g in zip(_TEX_PARAMS, grads)}
        return new, loss

    return step
