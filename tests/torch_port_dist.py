"""Rank workers and scenes of the port's scale-out tests.

Nothing here imports JAX: the workers run in processes spawned by
``deodr_tpu_torch.parallel.run_ranks``, each with one PyTorch thread, on
the CPU (gloo) unless told otherwise, and hand back numpy arrays. The card
tests (tests/test_torch_port_cuda.py) use them with ``device="cuda"``.
"""

import dataclasses

import numpy as np
import torch

from deodr_tpu_torch.geometry.primitives import octahedron_mesh
from deodr_tpu_torch.ops.render import render_scene, scene_buffers_from_numpy
from deodr_tpu_torch.ops.tiled import TilingConfig
from deodr_tpu_torch.parallel import sharding

PRODUCTION_TILING = dict(tile_h=8, tile_w=128, triangle_capacity=64, edge_capacity=32)


def production_scene_fields(h=64, w=256, n_tri=40, seed=21) -> dict:
    """tests/test_parallel.py::_production_scene as numpy fields: a textured
    scene (64×256, 40 triangles, 16×16 texture) for the tiled route."""
    rng = np.random.RandomState(seed)
    ctr = rng.rand(n_tri, 1, 2) * [w - 12, h - 12] + 6
    tri = ctr + (rng.rand(n_tri, 3, 2) - 0.5) * 18
    u = tri[:, 1] - tri[:, 0]
    v = tri[:, 2] - tri[:, 0]
    flip = u[:, 0] * v[:, 1] - v[:, 0] * u[:, 1] > 0
    tri[flip] = tri[flip][:, [0, 2, 1]]
    faces = np.arange(3 * n_tri, dtype=np.int32).reshape(n_tri, 3)
    return dict(
        faces=faces, faces_uv=faces, ij=tri.reshape(-1, 2), depths=np.repeat(rng.rand(n_tri) + 0.5, 3),
        uv=rng.rand(3 * n_tri, 2) * 13 + 1, shade=rng.rand(3 * n_tri), colors=rng.rand(3 * n_tri, 3),
        edgeflags=np.ones((n_tri, 3), bool), textured=rng.rand(n_tri) < 0.5, shaded=np.ones(n_tri, bool),
        texture=rng.rand(16, 16, 3), background_image=None, background_color=rng.rand(3), height=h, width=w,
    )


def cosine_weights(shape, dtype, device) -> torch.Tensor:
    """cos(0, 1, 2, ...) over an image: the weights of the JAX test's loss."""
    n = int(np.prod(shape))
    return torch.cos(torch.arange(n, dtype=dtype, device=device)).reshape(shape)


def collectives() -> list:
    return [tuple(c) for c in sharding.COLLECTIVES]


def _mesh(n_views, n_tiles, device):
    return sharding.make_device_mesh(n_views, n_tiles, device_type=device)


def tile_sharded(rank, world, fields, sigma, cap, tiling_kw, device="cpu", dtype=torch.float64, impl="kernel"):
    """The tile-sharded render of ``fields`` over a (1, world) mesh and the
    gradients to ij and colors of the cosine-weighted loss → numpy results
    and the collectives of the forward and of the backward."""
    mesh = _mesh(1, world, device)
    scene = scene_buffers_from_numpy(fields, device=device, dtype=dtype)
    ij = scene.ij.clone().requires_grad_(True)
    colors = scene.colors.clone().requires_grad_(True)
    render = sharding.make_tile_sharded_render(scene, sigma, mesh, aa_edge_capacity=cap,
                                               tiling=None if tiling_kw is None else TilingConfig(**tiling_kw),
                                               impl=impl)
    from deodr_tpu_torch.ops import kernels

    kernels.reset_launches()
    sharding.reset_collectives()
    image, z = render(dataclasses.replace(scene, ij=ij, colors=colors))
    forward = collectives()
    sharding.reset_collectives()
    loss = (image * cosine_weights(image.shape, image.dtype, image.device)).sum()
    loss.backward()
    return dict(image=image.detach().cpu().numpy(), z=z.cpu().numpy(), g_ij=ij.grad.cpu().numpy(),
                g_colors=colors.grad.cpu().numpy(), forward=forward, backward=collectives(),
                launches=dict(kernels.LAUNCHES))


def textured_multiview(rank, world, fields, ij_batch, obs, params, lr, sigma, cap, n_steps, device="cpu",
                       plan=None):
    """``n_steps`` of the textured multi-view step over a (world, 1) mesh →
    the losses, the final parameters and the collectives of the steps.
    ``plan`` = (tiling, aa_tex_plan) for the tiled route, or None."""
    from deodr_tpu_torch.ops import kernels

    mesh = _mesh(world, 1, device)
    buffers = scene_buffers_from_numpy(fields, device=device)
    tiling, tex_plan = plan if plan is not None else (None, None)
    step = sharding.make_textured_multiview_step(buffers, sigma, mesh, lr=lr, aa_edge_capacity=cap, tiling=tiling,
                                                 aa_tex_plan=tex_plan)
    p = {k: torch.from_numpy(v).to(device) for k, v in params.items()}
    ij_batch, obs = (torch.from_numpy(a).to(device) for a in (ij_batch, obs))
    kernels.reset_launches()
    sharding.reset_collectives()
    losses = []
    for _ in range(n_steps):
        p, loss = step(p, ij_batch, obs)
        losses.append(float(loss))
    return dict(losses=losses, params={k: v.cpu().numpy() for k, v in p.items()}, collectives=collectives(),
                launches=dict(kernels.LAUNCHES))


def octahedron_static(height, width, cap=16, level=1):
    """The static tuple of the untextured multi-view step for
    ``octahedron_mesh(level)``, and the mesh's vertices."""
    mesh = octahedron_mesh(level)
    adj = mesh.adjacencies
    static = (mesh.faces, adj.edges, adj.edge_faces, adj.faces_edges, adj.degree_v_e, height, width, 1.0, cap,
              np.array([0.1, 0.2, 0.3]))
    return static, mesh.vertices.detach().cpu().numpy()


def multiview(rank, world, static, params, obs, extrinsics, intrinsics, lr, n_steps):
    """``n_steps`` of the untextured multi-view step over a (world, 1) mesh
    on the CPU → losses, final parameters, collectives."""
    mesh = _mesh(world, 1, "cpu")
    step = sharding.make_multiview_train_step(static, mesh, lr=lr)
    p = {k: torch.as_tensor(v) for k, v in params.items()}
    obs, extrinsics, intrinsics = (torch.from_numpy(a) for a in (obs, extrinsics, intrinsics))
    sharding.reset_collectives()
    losses = []
    for _ in range(n_steps):
        p, loss = step(p, obs, extrinsics, intrinsics)
        losses.append(float(loss))
    return dict(losses=losses, params={k: v.numpy() for k, v in p.items()}, collectives=collectives())


def octahedron_fitter(n_frames, h, w, device="cpu", level=1, dtype=torch.float64):
    """The multi-frame fitter of tests/test_parallel.py on octahedron_mesh(level)."""
    from deodr_tpu_torch.mesh_fitter import MeshRGBFitterWithPoseMultiFrame

    base = octahedron_mesh(level)
    rng = np.random.RandomState(0)
    images = [np.clip(0.5 + 0.2 * rng.rand(h, w, 3), 0, 1) for _ in range(n_frames)]
    f = MeshRGBFitterWithPoseMultiFrame(
        vertices=base.vertices.detach().cpu().numpy(), faces=base.faces, euler_init=np.zeros((n_frames, 3)),
        translation_init=np.zeros((n_frames, 3)), default_color=np.array([0.4, 0.3, 0.25]),
        default_light_directional=np.array([0.1, 0.5, 0.4]), default_light_ambient=0.6, device=device, dtype=dtype,
    )
    f.set_background_color(np.array([0.1, 0.2, 0.3]))
    f.set_images(images)
    return f


def fitter_state(f) -> dict:
    return dict(vertices=f.vertices, quaternion=f.transform_quaternion, translation=f.transform_translation,
                mesh_color=f.mesh_color, light_directional=f.light_directional,
                light_ambient=np.asarray(f.light_ambient))


def sharded_fitter(rank, world, n_frames, h, w, steps, device="cpu", level=1):
    """``steps`` of the multi-frame fitter view-sharded over a (world,) views
    axis → energies, final state, the last step's images, collectives."""
    import contextlib
    import io

    from deodr_tpu_torch.ops import kernels

    f = octahedron_fitter(n_frames, h, w, device, level)
    f.set_device_mesh(_mesh(world, 1, device))
    kernels.reset_launches()
    sharding.reset_collectives()
    with contextlib.redirect_stdout(io.StringIO()):
        outs = [f.step() for _ in range(steps)]
    return dict(energies=[o[0] for o in outs], state=fitter_state(f), images=np.stack([im.cpu().numpy() for im in outs[-1][1]]),
                collectives=collectives(), launches=dict(kernels.LAUNCHES))


def sequential_fitter(n_frames, h, w, steps, device="cpu", level=1) -> dict:
    """The same fitter's ``steps`` in one process, without a mesh."""
    import contextlib
    import io

    f = octahedron_fitter(n_frames, h, w, device, level)
    with contextlib.redirect_stdout(io.StringIO()):
        outs = [f.step() for _ in range(steps)]
    return dict(energies=[o[0] for o in outs], state=fitter_state(f), images=np.stack([im.cpu().numpy() for im in outs[-1][1]]))


def single_render(fields, sigma, cap, tiling_kw, device="cpu", dtype=torch.float64, impl="kernel") -> dict:
    """The single-process render and gradients of :func:`tile_sharded`."""
    scene = scene_buffers_from_numpy(fields, device=device, dtype=dtype)
    ij = scene.ij.clone().requires_grad_(True)
    colors = scene.colors.clone().requires_grad_(True)
    image, z, _ = render_scene(dataclasses.replace(scene, ij=ij, colors=colors), sigma, aa_edge_capacity=cap,
                               tiling=None if tiling_kw is None else TilingConfig(**tiling_kw), impl=impl)
    (image * cosine_weights(image.shape, image.dtype, image.device)).sum().backward()
    return dict(image=image.detach().cpu().numpy(), z=z.cpu().numpy(), g_ij=ij.grad.cpu().numpy(),
                g_colors=colors.grad.cpu().numpy())


def mesh_facts(rank, world):
    """make_device_mesh's shapes and names at every split of ``world``, its
    size check, and the multi-frame fitter's two ValueErrors."""
    from torch.distributed.device_mesh import init_device_mesh

    out = {}
    for n_views in (1, 2, world):
        mesh = sharding.make_device_mesh(n_views, device_type="cpu")
        out[n_views] = (tuple(mesh.shape), tuple(mesh.mesh_dim_names), mesh.get_local_rank("views"),
                        mesh.get_local_rank("tiles"))
    errors = []
    try:
        sharding.make_device_mesh(world + 1, 1, device_type="cpu")
    except ValueError as e:
        errors.append(str(e))
    fitter = octahedron_fitter(3, 8, 8)
    try:
        fitter.set_device_mesh(init_device_mesh("cpu", (world,), mesh_dim_names=("tiles",)))
    except ValueError as e:
        errors.append(str(e))
    fitter.set_device_mesh(sharding.make_device_mesh(world, 1, device_type="cpu"))
    try:
        fitter.step()
    except ValueError as e:
        errors.append(str(e))
    out["errors"] = errors
    return out
