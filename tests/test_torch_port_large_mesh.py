"""The port's large-mesh binning (deodr_tpu_torch.ops.tiled: pair
expansion and supertiles) against the JAX package's on the CPU:

- ``_bin_to_tiles_pairs`` and ``_bin_to_tiles_hier`` against JAX's on the
  same seeded boxes, ``slots``, ``slot_valid`` and ``counts`` exactly,
  with ranks at and beyond the capacity and an overflowing supertile;
- renders with pair and supertile tilings against JAX's ``render_scene``
  on the scenes and tilings of tests/test_tiled.py (pair binning, with
  drawn compaction and σ = 1) and tests/test_hier_binning.py (``HIER``):
  image, z-buffer and the gradients to ij and colors within 1e-9 in float64
  (against the XLA route at σ = 0 and the Pallas route in interpret mode
  at σ = 1, whose band test is the port's);
- the overflow messages with ``check_capacity=True``;
- ``Scene3D._eager_plan`` on ``octahedron_mesh`` field by field against
  JAX's kernel-route plan (``impl="pallas"``), once per binner, and the
  port's renders with supertile and pair tilings equal to dense binning.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_scenes  # noqa: F401  (one PyTorch thread a worker)
from deodr_tpu import default_camera as jax_default_camera
from deodr_tpu.geometry.primitives import octahedron_mesh as jax_octahedron_mesh
from deodr_tpu.ops import tiled as jax_tiled
from deodr_tpu.ops.render import render_scene as jax_render_scene
from deodr_tpu.scene import Scene3D as JaxScene3D
from deodr_tpu_torch import Scene3D, TilingConfig, default_camera, render_scene
from deodr_tpu_torch.geometry.primitives import octahedron_mesh
from deodr_tpu_torch.ops import tiled
from deodr_tpu_torch.ops.kernels import TileGrid
from deodr_tpu_torch.ops.render import scene_buffers_from_numpy
from examples.triangle_soup_fitting import create_example_scene
from test_hier_binning import HIER
from test_hier_binning import _scene as hier_scene

LIMIT = 1e-9


# ------------------------------------------------------------ the binners


def _boxes(seed=3, n=200):
    """Seeded clamped pixel boxes over a 12 × 2 grid of 8 × 128 tiles, as
    tests/test_hier_binning.py::test_bin_boxes_matches_dense makes them."""
    rng = np.random.RandomState(seed)
    x_lo = np.floor(rng.rand(n) * 250)
    x_hi = x_lo + np.floor(rng.rand(n) * 40)
    y_lo = np.floor(rng.rand(n) * 90)
    y_hi = y_lo + np.floor(rng.rand(n) * 30)
    return x_lo, x_hi, y_lo, y_hi, rng.rand(n) > 0.1


@pytest.mark.parametrize(
    "binner, capacity, extra",
    [("pairs", 64, (5, 2)), ("pairs", 4, (5, 2)), ("pairs", 24, (5, 2)),
     ("supertiles", 64, ((4, 1), 200)), ("supertiles", 4, ((4, 1), 200)), ("supertiles", 64, ((4, 1), 50)),
     ("supertiles", 16, ((5, 2), 120))],
    ids=["pairs", "pairs-ranks-over-cap", "pairs-some-over-cap", "super", "super-ranks-over-cap",
         "super-overflow", "super-partial"],
)
def test_binners_match_jax(binner, capacity, extra):
    """Slot lists, validity and counts equal to JAX's, entry for entry
    (padding slots included), at capacities that hold and that drop ranks;
    ``supertiles`` also with an overflowing supertile (50 candidates) and
    supertiles that overhang the grid (5 × 2 tiles on 12 × 2)."""
    boxes = _boxes()
    n_ty, n_tx, th, tw = 12, 2, 8, 128
    t = [torch.from_numpy(a) for a in boxes]
    j = [jnp.asarray(a) for a in boxes]
    grid = TileGrid(n_ty, n_tx, th, tw)
    checks_p, checks_j = [], []
    if binner == "pairs":
        got = tiled._bin_to_tiles_pairs(*t, grid, capacity, *extra, checks=checks_p)
        want = jax_tiled._bin_to_tiles_pairs(*j, n_ty, n_tx, th, tw, capacity, *extra, checks=checks_j)[:3]
    else:
        got = tiled._bin_to_tiles_hier(*t, grid, capacity, *extra, checks=checks_p)
        want = jax_tiled._bin_to_tiles_hier(*j, n_ty, n_tx, th, tw, capacity, *extra, checks=checks_j)
    for name, a, b in zip(("slots", "slot_valid", "counts"), got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    assert [(label, int(count), cap) for label, count, cap in checks_p] == \
        [(label, int(count), cap) for label, count, cap in checks_j]


def test_bin_boxes_dispatches_in_jax_order():
    """Pairs before supertiles; supertiles only on a grid larger than one
    supertile; dense otherwise."""
    t = [torch.from_numpy(a) for a in _boxes()]
    grid = TileGrid(12, 2, 8, 128)
    base = TilingConfig(tile_h=8, tile_w=128, triangle_capacity=64)
    dense = tiled._bin_to_tiles(*t, grid, 64)
    both = base._replace(pair_ry=5, pair_rx=2, super_ty=4, super_tx=1, super_capacity=8)
    checks = []
    tiled._bin_boxes(both, *t, grid, 64, checks)
    assert [c[0] for c in checks] == ["pair-binning y tile span", "pair-binning x tile span"]
    one_supertile = base._replace(super_ty=12, super_tx=2, super_capacity=8)
    checks = []
    got = tiled._bin_boxes(one_supertile, *t, grid, 64, checks)
    assert checks == [] and all(torch.equal(a, b) for a, b in zip(got, dense))


# ------------------------------------------------------------ the renders


def _soup(seed, n_tri=40, width=256, height=128):
    """The triangle soup of tests/test_tiled.py's pair-binning tests →
    (JAX SceneBuffers, the port's on the CPU)."""
    np.random.seed(seed)
    scene2d = create_example_scene(n_tri=n_tri, width=width, height=height)
    scene2d.backface_culling = True
    base = scene2d._buffers(*scene2d._diff_inputs())
    return base, _port_buffers(base)


def _port_buffers(jax_buffers):
    fields = {f.name: getattr(jax_buffers, f.name) for f in dataclasses.fields(jax_buffers)}
    fields = {k: np.asarray(v) if hasattr(v, "shape") else v for k, v in fields.items()}
    return scene_buffers_from_numpy(fields, device="cpu")


def _jax_grads(base, sigma, tiling, impl, aa):
    def loss(ij, colors):
        img, zb, _ = jax_render_scene(dataclasses.replace(base, ij=ij, colors=colors), sigma, aa_edge_capacity=aa,
                                      tiling=tiling, impl=impl, impl_interpret=impl == "pallas")
        return jnp.sum(img * jnp.sin(jnp.arange(img.size).reshape(img.shape))), (img, zb)

    (_, (img, zb)), g = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(base.ij, base.colors)
    return [np.asarray(a) for a in (img, zb) + tuple(g)]


def _port_grads(buffers, sigma, tiling, aa, check_capacity=True):
    ij = buffers.ij.clone().requires_grad_(True)
    colors = buffers.colors.clone().requires_grad_(True)
    img, zb, _ = render_scene(dataclasses.replace(buffers, ij=ij, colors=colors), sigma, aa_edge_capacity=aa,
                              tiling=tiling, check_capacity=check_capacity)
    weight = torch.sin(torch.arange(img.numel(), dtype=img.dtype).reshape(img.shape))
    g = torch.autograd.grad((img * weight).sum(), (ij, colors))
    return [a.detach().numpy() for a in (img, zb) + g]


def _hold(got, want, limit=LIMIT):
    names = ("image", "z", "grad ij", "grad colors")
    fin = np.isfinite(want[1])
    np.testing.assert_array_equal(np.isfinite(got[1]), fin)
    for name, a, b in zip(names, got, want):
        if name == "z":
            a, b = a[fin], b[fin]
        assert np.abs(a - b).max(initial=0.0) <= limit * max(1.0, np.abs(b).max(initial=0.0)), name


def _port_tiling(jax_tiling):
    return TilingConfig(**{k: getattr(jax_tiling, k) for k in TilingConfig._fields})


def test_pair_binning_render_matches_jax():
    """tests/test_tiled.py::test_pair_binning_matches_dense's scene and
    tiling (σ = 0): the port's pair-binned render against JAX's XLA route."""
    base, buffers = _soup(11)
    t_pair = jax_tiled.TilingConfig(tile_h=16, tile_w=128, triangle_capacity=32, edge_capacity=64, pair_ry=8,
                                    pair_rx=2)
    _hold(_port_grads(buffers, 0.0, _port_tiling(t_pair), None), _jax_grads(base, 0.0, t_pair, "xla", None))


def test_pair_binning_with_drawn_compaction_and_sigma_matches_jax():
    """tests/test_tiled.py::test_pair_binning_with_drawn_compaction_and_sigma
    (drawn compaction, 8-row edge tiles, σ = 1) against JAX's Pallas route
    in interpret mode, every active edge kept (that test's 96-edge
    compaction overflows, which ``check_capacity`` refuses)."""
    base, buffers = _soup(13)
    t_pair = jax_tiled.TilingConfig(tile_h=16, tile_w=128, triangle_capacity=32, edge_capacity=64, drawn_capacity=48,
                                    edge_tile_h=8, pair_ry=8, pair_rx=2)
    _hold(_port_grads(buffers, 1.0, _port_tiling(t_pair), None), _jax_grads(base, 1.0, t_pair, "pallas", None))


@pytest.mark.parametrize("sigma", [0.0, 1.0])
def test_supertile_render_matches_jax(sigma):
    """tests/test_hier_binning.py's scene with ``HIER`` (4 × 1 supertiles of
    80 candidates): against JAX's XLA route at σ = 0, its Pallas route in
    interpret mode at σ = 1, every active edge kept and 64 slots an edge
    tile (the 64-edge compaction and 32-slot edge bins of that file
    overflow at σ = 1, which ``check_capacity`` refuses)."""
    base = hier_scene()
    impl = "xla" if sigma == 0 else "pallas"
    tiling = HIER._replace(edge_capacity=64)
    _hold(_port_grads(_port_buffers(base), sigma, _port_tiling(tiling), None),
          _jax_grads(base, sigma, tiling, impl, None))


@pytest.mark.parametrize("binner", ["pairs", "supertiles"])
def test_large_mesh_overflow_is_loud(binner):
    """A box spanning more tile rows than ``pair_ry`` (the soup of
    tests/test_tiled.py::test_pair_binning_span_overflow_raises), and a
    supertile of more candidates than ``super_capacity``
    (tests/test_hier_binning.py::test_supertile_overflow_is_loud), raise
    with ``check_capacity=True``."""
    if binner == "pairs":
        _, buffers = _soup(11)
        tiling = TilingConfig(tile_h=16, tile_w=128, triangle_capacity=32, edge_capacity=64, pair_ry=2, pair_rx=2)
        message = "pair-binning y tile span overflow"
    else:
        buffers = _port_buffers(hier_scene(seed=13))
        tiling = _port_tiling(HIER._replace(super_capacity=4))
        message = "supertile bin overflow"
    with pytest.raises(RuntimeError, match=message):
        render_scene(buffers, 0.0, tiling=tiling, check_capacity=True)


# ------------------------------------------------------------ Scene3D plans


def _octahedron_scenes(level, width, height, sigma):
    """size_sweep's configuration (tools/size_sweep.py::run_config) in both
    packages → (port scene, JAX scene, port camera, JAX camera)."""
    rot = np.array([[1.0, 0, 0], [0, -1, 0], [0, 0, -1]])
    mesh_p, mesh_j = octahedron_mesh(level), jax_octahedron_mesh(level)
    camera_p = default_camera(width, height, 60, mesh_p.vertices.numpy(), rot)
    camera_j = jax_default_camera(width, height, 60, np.asarray(mesh_j.vertices), rot)
    scene_p, scene_j = Scene3D(sigma=sigma, device="cpu"), JaxScene3D(sigma=sigma, impl="pallas")
    for s, m in ((scene_p, mesh_p), (scene_j, mesh_j)):
        s.set_mesh(m)
        s.set_light(np.array([-0.4, -0.4, -0.8]), 0.4)
        s.set_background_color(np.array([0.2, 0.3, 0.5]))
    return scene_p, scene_j, camera_p, camera_j


@pytest.mark.parametrize(
    "level, width, height, sigma, binner",
    [(5, 640, 512, 0.0, "dense"), (5, 2048, 2048, 0.0, "supertiles"), (6, 256, 256, 1.0, "pairs")],
)
def test_scene3d_plan_matches_jax(level, width, height, sigma, binner):
    """The port's plan equals JAX's kernel-route plan field by field, and
    picks the binner named. At 640×512 both keep dense binning: JAX's test
    of supertiles there (test_planner_auto_supertiles_match_dense) plans
    its XLA route, 8-row × 64-wide tiles over all 8192 faces."""
    scene_p, scene_j, camera_p, camera_j = _octahedron_scenes(level, width, height, sigma)
    plan_p, plan_j = scene_p._eager_plan(camera_p), scene_j._eager_plan(camera_j)
    assert (plan_p[0], plan_p[2], plan_p[3], plan_p[4]) == (plan_j[0], plan_j[2], plan_j[3], plan_j[4])
    for name in plan_p[1]._fields:
        assert getattr(plan_p[1], name) == getattr(plan_j[1], name), name
    tiling = plan_p[1]
    picked = ("pairs" if tiling.pair_ry * tiling.pair_rx else "supertiles" if tiling.super_capacity else "dense")
    assert picked == binner


@pytest.mark.parametrize("binner", ["supertiles", "pairs"])
def test_scene3d_large_mesh_render_matches_dense(binner):
    """Scene3D's buffers rendered with a large-mesh tiling equal the same
    plan with dense binning, in float64: image and z bit-equal, gradients to
    ij and colors within 1e-9 of scale. "supertiles": octahedron_mesh(5) at
    640×512 (tests/test_hier_binning.py::test_planner_auto_supertiles_match_dense's
    configuration) with the plan's tiles and 8 × 4 supertiles of 1024
    candidates; "pairs": octahedron_mesh(6) at 256² at σ = 1, as planned."""
    if binner == "supertiles":
        scene, _, camera, _ = _octahedron_scenes(5, 640, 512, 0.0)
    else:
        scene, _, camera, _ = _octahedron_scenes(6, 256, 256, 1.0)
    cap, tiling = scene._eager_plan(camera)[:2]
    if binner == "supertiles":
        tiling = tiling._replace(super_ty=8, super_tx=4, super_capacity=1024)
    dense = tiling._replace(super_ty=0, super_tx=0, super_capacity=0, pair_ry=0, pair_rx=0)
    buffers, _ = scene._build_buffers(camera, *scene._diff_inputs(False), True, None)
    buffers = dataclasses.replace(buffers, ij=buffers.ij.detach(), colors=buffers.colors.detach(),
                                  depths=buffers.depths.detach())
    got = _port_grads(buffers, scene.sigma, tiling, cap)
    want = _port_grads(buffers, scene.sigma, dense, cap)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    _hold(got, want)
