"""The port's scale-out (``deodr_tpu_torch.parallel`` and the multi-frame
fitter's ``set_device_mesh``) against the JAX package on the CPU, in
float64.

The port's ranks are processes spawned by ``run_ranks`` over gloo (workers
in tests/torch_port_dist.py, one PyTorch thread each); the JAX side runs in
this process on conftest's 8-device CPU mesh, under ``jax.jit``:

- (a) ``make_device_mesh``: shapes, names and coordinates at every split of
  4 ranks, and its size check; the fitter's two ValueErrors;
- (b) the tile-sharded render of tests/test_parallel.py's production scene
  (textured, 64×256, 40 triangles, 8×128 tiles, σ = 1) at 2 and 4 ranks
  against JAX's Pallas kernels (interpret mode) sharded over as many tiles
  and against the port's single-process render: image and z within 1e-9,
  the gradients to ij and colors of the cosine-weighted loss within 1e-9 of
  their scale (no world-size factor); one all-gather in the forward, one
  all-reduce of exactly the ij and colors gradients in the backward;
- (c) the textured multi-view step, two steps from the JAX test's inputs,
  at 2 and 4 ranks against JAX's step over 8 views: loss and parameters at
  rtol 1e-9 / atol 1e-12; each step's one all-reduce carries texture + uv +
  shade + the loss and nothing more;
- (d) the untextured multi-view step at 2 ranks on an octahedron with 4
  views against JAX's, 1e-9;
- (e) the multi-frame fitter view-sharded at 2 and 4 ranks with the inputs
  and tolerances of test_multiframe_fitter_view_sharded_matches_sequential,
  against the port's sequential fitter and JAX's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.spatial.transform
import torch

import torch_port_dist as dist_workers
from deodr_tpu.ops.render import SceneBuffers as JaxBuffers
from deodr_tpu.ops.tiled import TilingConfig as JaxTiling
from deodr_tpu_torch.parallel import run_ranks
from test_parallel import _production_scene

WORLDS = (2, 4)
SIGMA, CAP = 1.0, 64


def ranks(fn, world, *args):
    return run_ranks(fn, world, args, device="cpu", threads=1)


def jax_buffers(fields) -> JaxBuffers:
    return JaxBuffers(**{k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in fields.items()})


def rel(a, b) -> float:
    """max |a − b| over the larger of 1 and max |b|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max()) / max(1.0, float(np.abs(b).max()))


def finite(z):
    z = np.asarray(z)
    return np.where(np.isfinite(z), z, 0.0)


def test_production_fields_equal_the_jax_scene():
    jax_scene = _production_scene()
    for k, v in dist_workers.production_scene_fields().items():
        if isinstance(v, np.ndarray):
            assert np.array_equal(np.asarray(getattr(jax_scene, k)), v), k


def test_device_mesh_shapes_names_and_checks():
    for rank, facts in enumerate(ranks(dist_workers.mesh_facts, 4)):
        assert facts[1] == ((1, 4), ("views", "tiles"), 0, rank)
        assert facts[2] == ((2, 2), ("views", "tiles"), rank // 2, rank % 2)
        assert facts[4] == ((4, 1), ("views", "tiles"), rank, 0)
        assert facts["errors"] == ["5x1 != 4 devices", "device mesh must have a 'views' axis",
                                   "nb_frames=3 must be divisible by the 'views' mesh size 4"]


# ------------------------------------------------------------ (b) tile-sharded render


@pytest.fixture(scope="module")
def port_single():
    return dist_workers.single_render(dist_workers.production_scene_fields(), SIGMA, CAP,
                                      dist_workers.PRODUCTION_TILING)


def jax_tile_sharded(world):
    """JAX's shard_render_scene on the Pallas kernels (interpret mode) over
    ``world`` tiles: image, z and the cosine-weighted loss's gradients."""
    from deodr_tpu.parallel.sharding import make_device_mesh, make_tile_sharded_render

    buffers = _production_scene()
    mesh = make_device_mesh(n_views=1, n_tiles=world, devices=jax.devices()[:world])
    render = make_tile_sharded_render(buffers, SIGMA, mesh, aa_edge_capacity=CAP,
                                      tiling=JaxTiling(**dist_workers.PRODUCTION_TILING), impl="pallas",
                                      impl_interpret=True)

    def loss(ij, colors):
        img, _ = render(dataclasses.replace(buffers, ij=ij, colors=colors))
        return jnp.sum(img * jnp.cos(jnp.arange(img.size).reshape(img.shape)))

    image, z = render(buffers)
    g_ij, g_colors = jax.jit(jax.grad(loss, argnums=(0, 1)))(buffers.ij, buffers.colors)
    return dict(image=image, z=z, g_ij=g_ij, g_colors=g_colors)


@pytest.mark.parametrize("world", WORLDS)
def test_tile_sharded_render_matches_jax_and_single_process(world, port_single):
    fields = dist_workers.production_scene_fields()
    want = jax_tile_sharded(world)
    frame_bytes = fields["height"] * fields["width"] * 3 * 8
    for got in ranks(dist_workers.tile_sharded, world, fields, SIGMA, CAP, dist_workers.PRODUCTION_TILING):
        for ref in (want, port_single):
            assert np.abs(got["image"] - np.asarray(ref["image"])).max() <= 1e-9
            assert np.abs(finite(got["z"]) - finite(ref["z"])).max() <= 1e-9
            assert np.array_equal(np.isfinite(got["z"]), np.isfinite(np.asarray(ref["z"])))
            assert rel(got["g_ij"], ref["g_ij"]) <= 1e-9
            assert rel(got["g_colors"], ref["g_colors"]) <= 1e-9
        # the forward: one all-gather of the band (image and z); the backward: one all-reduce of the
        # ij and colors gradients, nothing of framebuffer size
        band_h = -(-fields["height"] // world)
        assert got["forward"] == [("all_gather", band_h * fields["width"] * 4 * 8, (band_h, fields["width"], 4), False)]
        n_grad = fields["ij"].size + fields["colors"].size
        assert got["backward"] == [("all_reduce", n_grad * 8, (n_grad,), True)]
        assert all(c[1] < frame_bytes for c in got["backward"])


# ------------------------------------------------------------ (c) textured multi-view step


N_VIEWS, TEX_CAP, TEX_LR, TEX_STEPS = 8, 192, 1e-6, 2


@pytest.fixture(scope="module")
def textured_inputs():
    """The JAX test's inputs (tests/test_parallel.py:297) and JAX's two
    steps over 8 views → (ij_batch, obs, params, losses, final params)."""
    from deodr_tpu.ops.render import render_scene
    from deodr_tpu.parallel.sharding import make_device_mesh, make_textured_multiview_step

    buffers = _production_scene()
    rng = np.random.RandomState(3)
    ij0 = np.asarray(buffers.ij)
    ij_batch = jnp.asarray(ij0[None] + rng.randn(N_VIEWS, *ij0.shape) * 0.1)

    def render_one(ij):
        img, _, _ = render_scene(dataclasses.replace(buffers, ij=ij), SIGMA, aa_edge_capacity=TEX_CAP)
        return img

    obs = jax.jit(jax.vmap(render_one))(ij_batch) + 0.03
    params = dict(texture=buffers.texture, uv=buffers.uv, shade=buffers.shade)
    mesh = make_device_mesh(n_views=N_VIEWS, n_tiles=1)
    step = make_textured_multiview_step(buffers, SIGMA, mesh, lr=TEX_LR, aa_edge_capacity=TEX_CAP)
    p, losses = params, []
    for _ in range(TEX_STEPS):
        p, loss = step(p, ij_batch, obs)
        losses.append(float(loss))
    as_np = lambda d: {k: np.asarray(v) for k, v in d.items()}  # noqa: E731
    return np.asarray(ij_batch), np.asarray(obs), as_np(params), losses, as_np(p)


@pytest.mark.parametrize("world", WORLDS)
def test_textured_multiview_step_matches_jax(world, textured_inputs):
    ij_batch, obs, params, losses, want = textured_inputs
    fields = dist_workers.production_scene_fields()
    n_bytes = (sum(v.size for v in params.values()) + 1) * 8
    for got in ranks(dist_workers.textured_multiview, world, fields, ij_batch, obs, params, TEX_LR, SIGMA, TEX_CAP,
                     TEX_STEPS):
        np.testing.assert_allclose(got["losses"], losses, rtol=1e-9)
        for k in params:
            np.testing.assert_allclose(got["params"][k], want[k], rtol=1e-9, atol=1e-12, err_msg=k)
        # exactly texture + uv + shade + the loss, once a step
        assert [c[:2] for c in got["collectives"]] == [("all_reduce", n_bytes)] * TEX_STEPS


# ------------------------------------------------------------ (d) untextured multi-view step


def multiview_inputs(n_views=4, h=24, w=32, seed=5):
    """Four views of octahedron_mesh(1) (poses perturbed per view, one
    camera), random observations, the JAX step's parameter dict."""
    from deodr_tpu_torch.camera import default_camera

    static, vertices = dist_workers.octahedron_static(h, w)
    rot = np.array([[1.0, 0, 0], [0, -1, 0], [0, 0, -1]])
    camera = default_camera(w, h, 60, vertices, rot)
    rng = np.random.RandomState(seed)
    params = dict(
        vertices=vertices,
        quaternion=scipy.spatial.transform.Rotation.from_euler("zyx", rng.randn(n_views, 3) * 0.2).as_quat(),
        translation=rng.randn(n_views, 3) * 0.05,
        mesh_color=np.array([0.5, 0.4, 0.3]), light_directional=np.array([-0.1, -0.5, -0.4]),
        light_ambient=np.asarray(0.6),
    )
    obs = rng.rand(n_views, h, w, 3)
    extrinsics = np.tile(camera.extrinsic[None], (n_views, 1, 1))
    intrinsics = np.tile(camera.intrinsic[None], (n_views, 1, 1))
    return static, params, obs, extrinsics, intrinsics


def test_multiview_train_step_matches_jax():
    from deodr_tpu.geometry.primitives import octahedron_mesh
    from deodr_tpu.parallel.sharding import make_device_mesh, make_multiview_train_step

    static, params, obs, extrinsics, intrinsics = multiview_inputs()
    lr, steps = 1e-4, 2
    mesh_j = octahedron_mesh(1)
    adj = mesh_j.adjacencies
    assert np.array_equal(np.asarray(adj.edge_faces_j), static[2])
    static_j = (jnp.asarray(mesh_j.faces), adj.edges_j, adj.edge_faces_j, adj.faces_edges_j, adj.degree_v_e_j,
                *static[5:9], jnp.asarray(static[9]))
    step = make_multiview_train_step(static_j, make_device_mesh(n_views=4, n_tiles=1, devices=jax.devices()[:4]), lr)
    p, losses = {k: jnp.asarray(v) for k, v in params.items()}, []
    for _ in range(steps):
        p, loss = step(p, jnp.asarray(obs), jnp.asarray(extrinsics), jnp.asarray(intrinsics))
        losses.append(float(loss))
    for got in ranks(dist_workers.multiview, 2, static, params, obs, extrinsics, intrinsics, lr, steps):
        np.testing.assert_allclose(got["losses"], losses, rtol=1e-9)
        for k in params:
            assert rel(got["params"][k], p[k]) <= 1e-9, k
        # a step: one all-reduce (shared gradients + loss), one all-gather (own poses' gradients)
        assert [c[0] for c in got["collectives"]] == ["all_reduce", "all_gather"] * steps
        assert got["collectives"][0][1] == (params["vertices"].size + 3 + 3 + 1 + 1) * 8


# ------------------------------------------------------------ (e) the multi-frame fitter


FRAMES, FIT_STEPS, FIT_H, FIT_W = 4, 3, 48, 64


@pytest.fixture(scope="module")
def sequential_fits():
    """The port's sequential fit and JAX's, as test_parallel.py builds them."""
    from deodr_tpu.geometry.primitives import octahedron_mesh
    from deodr_tpu.mesh_fitter import MeshRGBFitterWithPoseMultiFrame

    port = dist_workers.sequential_fitter(FRAMES, FIT_H, FIT_W, FIT_STEPS)
    base = octahedron_mesh(n_subdivision=1)
    rng = np.random.RandomState(0)
    f = MeshRGBFitterWithPoseMultiFrame(
        vertices=np.asarray(base.vertices), faces=np.asarray(base.faces), euler_init=np.zeros((FRAMES, 3)),
        translation_init=np.zeros((FRAMES, 3)), default_color=np.array([0.4, 0.3, 0.25]),
        default_light_directional=np.array([0.1, 0.5, 0.4]), default_light_ambient=0.6,
    )
    f.set_background_color(np.array([0.1, 0.2, 0.3]))
    f.set_images([np.clip(0.5 + 0.2 * rng.rand(FIT_H, FIT_W, 3), 0, 1) for _ in range(FRAMES)])
    energies = [f.step()[0] for _ in range(FIT_STEPS)]
    return port, dict(energies=energies, state=dist_workers.fitter_state(f))


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_multiframe_fitter_matches_sequential(world, sequential_fits):
    port, jax_fit = sequential_fits
    np.testing.assert_allclose(port["energies"], jax_fit["energies"], rtol=1e-9)
    for got in ranks(dist_workers.sharded_fitter, world, FRAMES, FIT_H, FIT_W, FIT_STEPS):
        for want in (port, jax_fit):
            np.testing.assert_allclose(got["energies"], want["energies"], rtol=1e-9)
            s, w = got["state"], want["state"]
            np.testing.assert_allclose(s["vertices"], w["vertices"], rtol=0, atol=1e-10)
            for k in ("quaternion", "mesh_color", "light_directional"):
                np.testing.assert_allclose(s[k], w[k], atol=1e-12, err_msg=k)
        np.testing.assert_allclose(got["images"], port["images"], rtol=0, atol=1e-12)
        # a step: one all-gather of the frames' results, one all-reduce of the shared gradients
        assert [c[0] for c in got["collectives"]] == ["all_gather", "all_reduce"] * FIT_STEPS
