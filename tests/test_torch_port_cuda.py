"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Skipped where there is no CUDA card: the CPU tests hold the plain versions
against the JAX package. On a machine with one card, from the repository
root (``--noconftest`` because tests/conftest.py configures JAX, which the
port does not use)::

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_cuda.py

The first case runs chip_smoke.py's kernel and main-path phases of the
untextured path at a small size: slot_map exact, z within 1e-5, images
within 1e-4, gradient tables within 1e-3 of their scale, and every kernel
of that path launched. The second holds the textured edge kernel against
its plain version on the small mixed scene of the CPU tests, in float64 to
1e-9 of scale (only the order of the atomic sums differs) and in float32 to
chip_smoke.py's limits, then the whole textured ``render_scene`` with
``impl="kernel"`` against ``impl="reference"``. The last two hold kernel B4
(the quad blend) against its plain versions, directly and through the quad
fetch, and ``Scene3D`` with the quad fetch against the per-pixel fetch on
the textured torus of tests/torch_port_scenes.py. The last four hold the
redesigned backward kernels against their plain versions on edge cases:
B1b at every tile height the planner picks (every cluster shape) with
uniform, striped and run-length slot maps, B4b at every channel count, and
B2b and B3b at every tile height and channel count on the synthetic edge
tables of tests/torch_port_scenes.py (tiles of 0, 1, 31, 33, 70 and more
slots, one at the capacity). The backward kernels that write whole tables
are checked to write every entry (a NaN-filled block waits in the caching
allocator) and, where they add nothing with atomics, to give bit-identical
tables from call to call. The last six hold the redesigned forward kernels
B1f, B2f and B3f against their plain versions at every tile height (B1f on
the synthetic raster tables of tests/torch_port_scenes.py: more than a
chunk of slots, equal z planes, NaN, denormal, infinite and invalid rows,
empty tiles, vertices on warp-region corners; B3f on the textured synthetic
edge tables), B4f bit for bit at every channel count, check that the
forward launchers refuse any shape but their helpers', and that the
float32 projection ignores TF32. Three more hold B1f in its non-strict and
perspective modes (every mode, D = 3, 4, 7, 8) and B1b at D = 4 and 8
against their plain versions, and the untiled ``render_scene`` and the
non-strict tiled one on the card against the CPU. The last two hold B1 and
B2 against their plain versions on the tables of the hand fitters' steps
(the depth fit's 200×200 frame with one channel, the RGB fit's 200×199
with three; float32 and float64; every fitter step launches the four
kernels once a render, and no other) and two fitter steps on the card in
float64 against the same steps on the CPU (1e-9). The last three hold
Scene2D untiled on the card against the CPU (the triangle soup, float64,
1e-9), Scene2D above 256 faces on the kernels against its plain versions
(B1 and B2 launched once a render; B1 alone when the scene holds a texture),
and render_deferred on the duck (B1f
at 14 attribute planes). The last three hold the large-mesh binners
(supertiles on octahedron_mesh(5) at 2048², pairs on levels 6 and 7)
against dense binning, B1b split over plane batches and slot windows
against its plain version, and a second backward of one render on the card
against the CPU. The last three hold the torch class surface
(``deodr_tpu_torch.interop``) on the kernels as chip_smoke.py's phase 11
does: ``Scene3DTorch`` on the duck and the hand against
``impl="reference"`` and against ``Scene3D`` in float64, and
``render_scene_torch`` against ``render_scene`` on the same plan.
"""

import os

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernels_and_main_path_match_plain_versions(cuda_device, dtype):
    import chip_smoke
    from deodr_tpu_torch import scene_buffers_from_numpy, suggest_tiling
    from deodr_tpu_torch.bench_scene import bench_scene_fields
    from deodr_tpu_torch.ops import kernels

    height, width, n_tri = 144, 256, 40
    fields = bench_scene_fields(height, width, n_tri)
    scene = scene_buffers_from_numpy(fields, device=cuda_device, dtype=dtype)
    tiling = suggest_tiling(fields["ij"], fields["faces"], height, width, sigma=1.0, edgeflags=fields["edgeflags"],
                            margin=1.0, for_pallas=True, bucket_mode="exact")
    obs = torch.from_numpy(np.random.RandomState(3).rand(height, width, 3)).to(cuda_device, dtype)
    chip_smoke.check_kernels(scene, tiling, obs, cuda_device, print)
    kernels.reset_launches()
    chip_smoke.main_path(scene, tiling, obs, print)
    untextured = ("raster_fwd", "raster_bwd", "edge_fwd", "edge_bwd")
    assert all(kernels.LAUNCHES[name] > 0 for name in untextured), kernels.LAUNCHES


@pytest.mark.parametrize("error_mode", [False, True], ids=["image", "error"])
@pytest.mark.parametrize("plan", ["unsplit", "split", "clamped"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_edge_tex_kernel_matches_plain_version(cuda_device, dtype, plan, error_mode):
    import dataclasses

    import deodr_tpu_torch as port
    from deodr_tpu_torch.ops import kernels
    from deodr_tpu_torch.ops.kernels import edge_tex_kernel as etk
    from deodr_tpu_torch.ops.render import scene_buffers_from_numpy
    from torch_port_scenes import AA_EDGE_CAPACITY, SIGMA, TILING, obs_image, plan_scene, tex_tables

    tight = dtype == torch.float64
    lim_out, lim_grad = (1e-9, 1e-9) if tight else (1e-4, 1e-3)

    def rel(a, b):
        return float((a - b).abs().max()) / max(float(b.abs().max()), 1.0)

    et, texture, buf, z_pad, obs_pad = tex_tables(plan, error_mode, dtype, cuda_device)
    args = (et.table_tile, texture, buf, z_pad, obs_pad, et.counts, et.grid, error_mode)
    kernels.reset_launches()
    out_k = etk.edge_tex_fwd(*args)
    out_r = etk.edge_tex_fwd(*args, impl="reference")
    assert float((out_k - out_r).abs().max()) <= lim_out
    g_out = torch.from_numpy(np.random.RandomState(6).randn(*out_r.shape)).to(cuda_device, dtype)
    bargs = (et.table_tile, texture, out_r, z_pad, obs_pad, g_out, et.counts, et.grid, error_mode)
    want = etk.edge_tex_bwd(*bargs, impl="reference")
    _prefill_allocator(want[0].numel(), dtype, cuda_device)
    got = etk.edge_tex_bwd(*bargs)
    again = etk.edge_tex_bwd(*bargs)
    torch.cuda.synchronize()
    for name, a, b in zip(("g_rows", "g_buf0", "g_texture"), got, want):
        assert float(b.abs().max()) > 0, name
        assert rel(a, b) <= lim_grad, name
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    assert kernels.LAUNCHES["edge_tex_fwd"] == 1 and kernels.LAUNCHES["edge_tex_bwd"] == 2

    # the whole textured render: kernels against plain versions
    fields, kw = plan_scene(plan)
    scene = scene_buffers_from_numpy(fields, device=cuda_device, dtype=dtype)
    obs = torch.from_numpy(obs_image()).to(cuda_device, dtype)
    names = ("ij", "colors", "uv", "shade", "texture")
    results = {}
    for impl in ("kernel", "reference"):
        leaves = {k: getattr(scene, k).clone().requires_grad_(True) for k in names}
        img, _, err = port.render_scene(
            dataclasses.replace(scene, **leaves), SIGMA, antialiase_error=error_mode, obs=obs,
            aa_edge_capacity=AA_EDGE_CAPACITY, tiling=port.TilingConfig(**TILING), aa_tex_plan=port.EdgeTexPlan(**kw),
            impl=impl, check_capacity=True,
        )
        out = err if error_mode else img
        grads = torch.autograd.grad((out * torch.cos(torch.arange(out.numel(), device=cuda_device).reshape(out.shape))).sum(),
                                    [leaves[k] for k in names])
        results[impl] = (out.detach(), dict(zip(names, grads)))
    assert float((results["kernel"][0] - results["reference"][0]).abs().max()) <= lim_out
    for k in names:
        assert rel(results["kernel"][1][k], results["reference"][1][k]) <= lim_grad, k


def _quad_blend_inputs(device, dtype, q=300, c=3, seed=2):
    """Window rows and offsets 0..6 (taps in the window's last row and
    column too), weights with the clamped values 0 and 1, a cotangent."""
    rng = np.random.RandomState(seed)
    win = torch.from_numpy(rng.randn(q, 64 * c)).to(device, dtype)
    dv = torch.from_numpy(rng.randint(0, 7, (q, 4)).astype(np.int32)).to(device)
    du = torch.from_numpy(rng.randint(0, 7, (q, 4)).astype(np.int32)).to(device)
    dv[0], du[0] = 6, 6
    ev = torch.from_numpy(rng.rand(q, 4)).to(device, dtype)
    eu = torch.from_numpy(rng.rand(q, 4)).to(device, dtype)
    ev[1], eu[1] = 0.0, 1.0
    ct = torch.from_numpy(rng.randn(q, 4, c)).to(device, dtype)
    return (win, dv, du, ev, eu), ct


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_quad_blend_kernel_matches_plain_version(cuda_device, dtype):
    """B4 on random windows, and through the quad fetch on uv that runs past
    every border of the texture (clamped taps) with seam quads in the
    per-pixel fallback: forward equal to the plain version, gradients within
    1e-12 (float64) or 1e-5 (float32) of their scale (index_add_ sums in
    another order on the card)."""
    from deodr_tpu_torch.ops import kernels
    from deodr_tpu_torch.ops.common import bilinear_sample_quads
    from deodr_tpu_torch.ops.kernels import quad_blend_kernel as qbk

    lim = 1e-12 if dtype == torch.float64 else 1e-5

    def rel(a, b):
        return float((a - b).abs().max()) / max(float(b.abs().max()), 1.0)

    args, ct = _quad_blend_inputs(cuda_device, dtype)
    kernels.reset_launches()
    assert torch.equal(qbk.quad_blend_fwd(*args), qbk.quad_blend_fwd(*args, impl="reference"))
    for a, b in zip(qbk.quad_blend_bwd(*args, ct), qbk.quad_blend_bwd(*args, ct, impl="reference")):
        assert float(b.abs().max()) > 0 and rel(a, b) <= lim
    assert kernels.LAUNCHES["quad_blend_fwd"] == 1 and kernels.LAUNCHES["quad_blend_bwd"] == 1

    rng = np.random.RandomState(4)
    th, tw, q = 32, 48, 256
    texture = torch.from_numpy(rng.randn(th, tw, 3)).to(cuda_device, dtype)
    uv = rng.uniform(-4.0, max(th, tw) + 4.0, (q, 1, 2)) + rng.uniform(0, 2.0, (q, 4, 2))
    uv[:40, 3] = rng.uniform(0, 20, (40, 2)) + 20.0  # seam quads
    uv = torch.from_numpy(uv).to(cuda_device, dtype)
    mask = torch.from_numpy(rng.rand(q, 4) > 0.2).to(cuda_device)
    weight = torch.from_numpy(rng.randn(q, 4, 3)).to(cuda_device, dtype) * mask[..., None]
    results = {}
    for impl in ("kernel", "reference"):
        t, u = texture.clone().requires_grad_(True), uv.clone().requires_grad_(True)
        out = bilinear_sample_quads(t, u, mask, 64, impl=impl)
        results[impl] = (out.detach(),) + torch.autograd.grad((out * weight).sum(), (t, u))
    torch.cuda.synchronize()
    assert torch.equal(results["kernel"][0], results["reference"][0])
    for a, b in zip(results["kernel"][1:], results["reference"][1:]):
        assert rel(a, b) <= lim


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_scene3d_quad_fetch_matches_per_pixel_fetch(cuda_device, dtype):
    """Scene3D on the textured torus with the quad fetch (kernel B4) against
    the per-pixel fetch, on the kernels: image within 1e-5 (float32) or 1e-12
    (float64), gradients within 1e-3 or 1e-9 of their scale."""
    from deodr_tpu_torch.camera import Camera
    from deodr_tpu_torch.geometry.mesh import ColoredTriMesh
    from deodr_tpu_torch.ops import kernels
    from deodr_tpu_torch.scene import Scene3D
    from torch_port_scenes import torus_arrays, torus_camera_arrays

    lim_img, lim_grad = (1e-12, 1e-9) if dtype == torch.float64 else (1e-5, 1e-3)
    a = torus_arrays()
    camera = Camera(*torus_camera_arrays())
    weight = torch.from_numpy(np.cos(np.arange(96 * 128 * 3)).reshape(96, 128, 3)).to(cuda_device, dtype)
    results = {}
    for quad in (False, True):
        mesh = ColoredTriMesh(a["faces"], torch.from_numpy(a["vertices"]).to(cuda_device, dtype), clockwise=False,
                              faces_uv=a["faces_uv"], uv=a["uv"], texture=a["texture"])
        scene = Scene3D(sigma=1.0, device=cuda_device, quad_fetch=quad)
        scene.set_mesh(mesh)
        scene.set_light(np.array([-0.4, -0.4, -0.8]), 0.4)
        scene.set_background_color(np.array([0.2, 0.3, 0.5]))
        kernels.reset_launches()
        image = scene.render(camera, check_capacity=True)
        scene.render_backward(weight)
        assert (kernels.LAUNCHES["quad_blend_fwd"] > 0) == quad and (kernels.LAUNCHES["quad_blend_bwd"] > 0) == quad
        results[quad] = (image, mesh._vertices_b, scene.light_directional_b, mesh.uv_b, mesh.texture_b)
    torch.cuda.synchronize()
    assert float((results[True][0] - results[False][0]).abs().max()) <= lim_img
    for a_q, a_p in zip(results[True][1:], results[False][1:]):
        assert float((a_q - a_p).abs().max()) <= lim_grad * max(float(a_p.abs().max()), 1.0)


def _rel(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1.0)


def _prefill_allocator(numel, dtype, device):
    """Leave NaN in the caching allocator's next block of this size, so an
    output from torch.empty shows any entry the kernel fails to write."""
    torch.full((numel,), float("nan"), dtype=dtype, device=device)
    torch.cuda.synchronize()


def _raster_bwd_inputs(device, dtype, tile_h, pattern, cap=24, d=7, seed=0):
    """A 2×3 grid of tile_h×128 tiles: tile 0 has count 0, tile 1 a count
    above cap (clamped), the others counts below cap. The slot map is one
    slot per tile (uniform warps), 1-pixel-wide stripes (every lane its own
    run) or random runs of 1..40 pixels along the rows, with misses (cap)
    and slots at or above the tile's count mixed in."""
    from deodr_tpu_torch.ops.kernels import TileGrid, from_tiles

    rng = np.random.RandomState(seed)
    grid = TileGrid(2, 3, tile_h, 128)
    counts = np.array([0, cap + 5, 10, 17, 1, cap - 1], np.int32)
    slots = np.empty((grid.n_tiles, tile_h, 128), np.int32)
    for t in range(grid.n_tiles):
        n = max(min(int(counts[t]), cap), 1)
        if pattern == "uniform":
            slots[t] = n - 1
        elif pattern == "stripes":
            slots[t] = np.arange(128)[None, :] % n
        else:
            flat = np.empty(tile_h * 128, np.int32)
            i = 0
            while i < flat.size:
                run = rng.randint(1, 41)
                flat[i:i + run] = rng.randint(0, cap + 1)
                i += run
            slots[t] = flat.reshape(tile_h, 128)
    slot_map = from_tiles(torch.from_numpy(slots), grid).contiguous().to(device)
    hp, wp = grid.padded_hw
    g_vals = torch.from_numpy(rng.randn(d, hp, wp)).to(device, dtype)
    return slot_map, g_vals, torch.from_numpy(counts).to(device), grid, cap


@pytest.mark.parametrize("pattern", ["uniform", "stripes", "runs"])
@pytest.mark.parametrize("tile_h", [8, 16, 32, 48])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_raster_bwd_kernel_matches_plain_version(cuda_device, dtype, tile_h, pattern):
    """B1b against its plain version at every cluster shape of the planner's
    tile heights: within 1e-12 (float64) or 1e-3 (float32) of scale; the
    output comes from torch.empty, so rows at or above a tile's count must be
    written exactly 0 (a NaN-filled block waits in the allocator), and one
    wrapper call is one launch."""
    from deodr_tpu_torch.ops import kernels
    from deodr_tpu_torch.ops.kernels import raster_kernel as rk

    lim = 1e-12 if dtype == torch.float64 else 1e-3
    slot_map, g_vals, counts, grid, cap = _raster_bwd_inputs(cuda_device, dtype, tile_h, pattern)
    want = rk.raster_bwd(slot_map, g_vals, counts, grid, cap, impl="reference")
    assert float(want.abs().max()) > 0
    _prefill_allocator(want.numel(), dtype, cuda_device)
    kernels.reset_launches()
    got = rk.raster_bwd(slot_map, g_vals, counts, grid, cap)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["raster_bwd"] == 1
    assert bool(torch.isfinite(got).all())
    for t, n in enumerate(counts.clamp(max=cap).tolist()):
        assert bool((got[t, n:] == 0).all()), t
    assert _rel(got, want) <= lim


@pytest.mark.parametrize("q", [5, 300])
@pytest.mark.parametrize("c", [1, 2, 3, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_quad_blend_bwd_kernel_matches_plain_version(cuda_device, dtype, c, q):
    """B4b at every channel count, with Q below and not a multiple of the 32
    quads a block stages, and tap offsets beyond 0..6 (clamped at 0 and 6):
    d_win, d_ev and d_eu within 1e-12 (float64) or 1e-5 (float32) of
    scale, window entries no tap reads exactly 0 (d_win comes from
    torch.empty_like; a NaN-filled block waits in the allocator)."""
    from deodr_tpu_torch.ops import kernels
    from deodr_tpu_torch.ops.kernels import quad_blend_kernel as qbk

    lim = 1e-12 if dtype == torch.float64 else 1e-5
    rng = np.random.RandomState(10 * c + q)
    win = torch.from_numpy(rng.randn(q, 64 * c)).to(cuda_device, dtype)
    dv = torch.from_numpy(rng.randint(-3, 10, (q, 4)).astype(np.int32)).to(cuda_device)
    du = torch.from_numpy(rng.randint(-3, 10, (q, 4)).astype(np.int32)).to(cuda_device)
    dv[0], du[0], dv[1], du[1] = 6, 0, -2, 9
    ev = torch.from_numpy(rng.rand(q, 4)).to(cuda_device, dtype)
    eu = torch.from_numpy(rng.rand(q, 4)).to(cuda_device, dtype)
    ct = torch.from_numpy(rng.randn(q, 4, c)).to(cuda_device, dtype)
    args = (win, dv, du, ev, eu, ct)
    want = qbk.quad_blend_bwd(*args, impl="reference")
    _prefill_allocator(win.numel(), dtype, cuda_device)
    kernels.reset_launches()
    got = qbk.quad_blend_bwd(*args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["quad_blend_bwd"] == 1
    for name, a, b in zip(("d_win", "d_ev", "d_eu"), got, want):
        assert float(b.abs().max()) > 0 and _rel(a, b) <= lim, name
    pos = ((dv.clamp(0, 6).long() * 8 + du.clamp(0, 6).long())[..., None]
           + torch.tensor([0, 1, 8, 9], device=cuda_device)).reshape(q, 16)
    read = torch.zeros((q, 64), dtype=torch.bool, device=cuda_device).scatter_(1, pos, True)
    unread = ~read[:, :, None].expand(q, 64, c).reshape(q, 64 * c)
    assert bool((got[0][unread] == 0).all()) and bool(torch.isfinite(got[0]).all())


def _check_edge_bwd(bwd, args, counts, cap, dtype, device, n_outputs):
    """One edge backward wrapper against its plain version: within 1e-9
    (float64) or chip_smoke.py's limits (float32: g_rows and g_texture 1e-3
    of scale, g_buf0 1e-4); g_rows from a NaN-filled allocator block, rows
    at or above a tile's count exactly 0, every entry finite, two calls'
    g_rows (and g_buf0) bit-identical, one launch per call."""
    from deodr_tpu_torch.ops import kernels

    lim_rows, lim_buf = (1e-9, 1e-9) if dtype == torch.float64 else (1e-3, 1e-4)
    want = bwd(*args, impl="reference")
    assert float(want[0].abs().max()) > 0
    _prefill_allocator(want[0].numel(), dtype, device)
    kernels.reset_launches()
    got = bwd(*args)
    again = bwd(*args)
    torch.cuda.synchronize()
    assert sum(kernels.LAUNCHES.values()) == 2
    assert len(got) == n_outputs and bool(torch.isfinite(got[0]).all())
    for t, n in enumerate(counts.clamp(max=cap).tolist()):
        assert bool((got[0][t, n:] == 0).all()), t
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    assert _rel(got[0], want[0]) <= lim_rows
    assert float((got[1] - want[1]).abs().max()) <= lim_buf
    if n_outputs == 3:
        assert float(want[2].abs().max()) > 0 and _rel(got[2], want[2]) <= lim_rows


@pytest.mark.parametrize("tile_h", [8, 16, 32, 48])
@pytest.mark.parametrize("error_mode", [False, True], ids=["image", "error"])
@pytest.mark.parametrize("c", [1, 2, 3, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_edge_bwd_kernel_matches_plain_version(cuda_device, dtype, c, error_mode, tile_h):
    """B2b against its plain version on the synthetic edge tables: tiles of
    0, 1, 31, 33, 70 slots, one at the capacity and one above it, at every
    cluster shape of the planner's tile heights."""
    from deodr_tpu_torch.ops.kernels import edge_kernel as ek
    from torch_port_scenes import SYNTH_CAP, synthetic_edge_tables

    table, _, _, final, z_pad, obs_pad, counts, grid = synthetic_edge_tables(tile_h, c, error_mode, False, dtype,
                                                                             cuda_device)
    g_out = torch.from_numpy(np.random.RandomState(c).randn(*final.shape)).to(cuda_device, dtype)
    args = (table, final, z_pad, obs_pad, g_out, counts, grid, error_mode)
    _check_edge_bwd(ek.edge_bwd, args, counts, SYNTH_CAP, dtype, cuda_device, 2)


@pytest.mark.parametrize("tile_h", [8, 16, 32, 48])
@pytest.mark.parametrize("error_mode", [False, True], ids=["image", "error"])
@pytest.mark.parametrize("c", [1, 2, 3, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_edge_tex_bwd_kernel_matches_plain_version(cuda_device, dtype, c, error_mode, tile_h):
    """B3b against its plain version on the synthetic edge tables with about
    half the slots textured (uv past the texture's borders) and the others
    plain with NaN uv, in tiles of up to 70 used slots."""
    from deodr_tpu_torch.ops.kernels import edge_tex_kernel as etk
    from torch_port_scenes import SYNTH_CAP, synthetic_edge_tables

    table, texture, _, final, z_pad, obs_pad, counts, grid = synthetic_edge_tables(tile_h, c, error_mode, True, dtype,
                                                                                   cuda_device)
    g_out = torch.from_numpy(np.random.RandomState(c).randn(*final.shape)).to(cuda_device, dtype)
    args = (table, texture, final, z_pad, obs_pad, g_out, counts, grid, error_mode)
    _check_edge_bwd(etk.edge_tex_bwd, args, counts, SYNTH_CAP, dtype, cuda_device, 3)


@pytest.mark.parametrize("textured", [False, True], ids=["plain", "textured"])
def test_edge_bwd_launchers_refuse_another_shared_size(cuda_device, textured, monkeypatch):
    """The shared bytes that edge_bwd_launch_shape hands an edge backward
    kernel's entry point are the ones its layout takes: 8 bytes fewer or
    more are refused with an error, and nothing is launched."""
    from deodr_tpu_torch.ops import kernels
    from deodr_tpu_torch.ops.kernels import edge_kernel as ek
    from deodr_tpu_torch.ops.kernels import edge_tex_kernel as etk
    from torch_port_scenes import synthetic_edge_tables

    table, texture, _, final, z_pad, obs_pad, counts, grid = synthetic_edge_tables(16, 3, False, textured,
                                                                                   torch.float32, cuda_device)
    g_out = torch.ones_like(final)
    if textured:
        call = lambda: etk.edge_tex_bwd(table, texture, final, z_pad, obs_pad, g_out, counts, grid, False)  # noqa: E731
    else:
        call = lambda: ek.edge_bwd(table, final, z_pad, obs_pad, g_out, counts, grid, False)  # noqa: E731
    call()
    shape = ek.edge_bwd_launch_shape
    for delta in (-8, 8):
        for module in (ek, etk):
            monkeypatch.setattr(module, "edge_bwd_launch_shape",
                                lambda *a, delta=delta: shape(*a)._replace(smem_bytes=shape(*a).smem_bytes + delta))
        kernels.reset_launches()
        with pytest.raises(RuntimeError, match="kernel failed"):
            call()
        assert sum(kernels.LAUNCHES.values()) == 0


@pytest.mark.parametrize("tile_h", [8, 16, 32, 48])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_raster_fwd_kernel_matches_plain_version(cuda_device, dtype, tile_h):
    """B1f against its plain version on the synthetic raster tables:
    slot_map and coverage (finite z) exact, z within 1e-5 and vals within
    1e-4 (float64: 1e-12); outputs from a NaN-filled allocator block, one
    launch per call."""
    from deodr_tpu_torch.ops import kernels
    from deodr_tpu_torch.ops.kernels import raster_kernel as rk
    from torch_port_scenes import RASTER_CAP, synthetic_raster_tables

    lim_z, lim_v = (1e-12, 1e-12) if dtype == torch.float64 else (1e-5, 1e-4)
    setup, affine, counts, grid = synthetic_raster_tables(tile_h, 7, dtype, cuda_device)
    slot_r, z_r, v_r = rk.raster_fwd(setup, affine, counts, grid, impl="reference")
    assert int(slot_r[slot_r < RASTER_CAP].max()) >= 64  # a winner from the second chunk
    fin = torch.isfinite(z_r)
    _prefill_allocator(v_r.numel(), dtype, cuda_device)
    kernels.reset_launches()
    slot_k, z_k, v_k = rk.raster_fwd(setup, affine, counts, grid)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["raster_fwd"] == 1
    assert torch.equal(slot_k, slot_r)
    assert torch.equal(torch.isfinite(z_k), fin)
    assert float((z_k[fin] - z_r[fin]).abs().max()) <= lim_z
    assert float((v_k - v_r).abs().max()) <= lim_v


RASTER_MODES = {"nonstrict": (False, False), "persp": (True, True), "nonstrict-persp": (False, True)}


@pytest.mark.parametrize("tile_h", [16, 48])
@pytest.mark.parametrize("d", [3, 4, 7, 8])
@pytest.mark.parametrize("mode", list(RASTER_MODES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_raster_fwd_kernel_modes_match_plain_version(cuda_device, dtype, mode, d, tile_h):
    """B1f in its non-strict and perspective modes against its plain
    version on the synthetic raster tables of the mode, at D = 3, 4, 7 and
    8 attribute planes: slot_map and coverage exact, z within 1e-5 and vals
    within 1e-4 (float64: 1e-12); outputs from a NaN-filled allocator
    block, one launch per call."""
    from deodr_tpu_torch.ops import kernels
    from deodr_tpu_torch.ops.kernels import raster_kernel as rk
    from torch_port_scenes import synthetic_raster_tables

    strict, persp = RASTER_MODES[mode]
    lim_z, lim_v = (1e-12, 1e-12) if dtype == torch.float64 else (1e-5, 1e-4)
    setup, affine, counts, grid = synthetic_raster_tables(tile_h, d, dtype, cuda_device, strict=strict, persp=persp)
    slot_r, z_r, v_r = rk.raster_fwd(setup, affine, counts, grid, impl="reference", strict=strict, persp=persp)
    fin = torch.isfinite(z_r)
    assert int(fin.sum()) > 0
    _prefill_allocator(v_r.numel(), dtype, cuda_device)
    kernels.reset_launches()
    slot_k, z_k, v_k = rk.raster_fwd(setup, affine, counts, grid, strict=strict, persp=persp)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["raster_fwd"] == 1
    assert torch.equal(slot_k, slot_r)
    assert torch.equal(torch.isfinite(z_k), fin)
    assert float((z_k[fin] - z_r[fin]).abs().max()) <= lim_z
    assert float((v_k - v_r).abs().max()) <= lim_v


@pytest.mark.parametrize("tile_h", [16, 48])
@pytest.mark.parametrize("d", [4, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_raster_bwd_kernel_matches_plain_version_at_more_planes(cuda_device, dtype, d, tile_h):
    """B1b at the attribute counts of the perspective modes (C + 1 planes
    untextured, C + 5 = 8 textured): as test_raster_bwd_kernel_matches_plain_version."""
    from deodr_tpu_torch.ops import kernels
    from deodr_tpu_torch.ops.kernels import raster_kernel as rk

    lim = 1e-12 if dtype == torch.float64 else 1e-3
    slot_map, g_vals, counts, grid, cap = _raster_bwd_inputs(cuda_device, dtype, tile_h, "runs", d=d)
    want = rk.raster_bwd(slot_map, g_vals, counts, grid, cap, impl="reference")
    _prefill_allocator(want.numel(), dtype, cuda_device)
    kernels.reset_launches()
    got = rk.raster_bwd(slot_map, g_vals, counts, grid, cap)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["raster_bwd"] == 1
    for t, n in enumerate(counts.clamp(max=cap).tolist()):
        assert bool((got[t, n:] == 0).all()), t
    assert _rel(got, want) <= lim


@pytest.mark.parametrize("case", ["s0", "s1-image", "s1-error-persp-windows", "s1-nonstrict-tiled"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_untiled_and_new_modes_render_on_the_card_as_on_the_cpu(cuda_device, dtype, case):
    """render_scene on the card (kernels) against the same call on the CPU
    (plain versions), forward and backward: the untiled route (sequential
    edge pass, windowed and not) and the tiled route in the non-strict
    mode; image within 1e-4 and gradients within 1e-3 of scale (float64:
    1e-9); every tensor of the card's render lies on the card."""
    import dataclasses

    import deodr_tpu_torch as port
    from deodr_tpu_torch.ops import kernels
    from torch_port_scenes import AA_EDGE_CAPACITY, HEIGHT, TILING, WIDTH, mixed_scene_fields

    f = mixed_scene_fields(tilt=0.5)
    sigma = 0.0 if case == "s0" else 1.5
    kwargs = dict(aa_edge_capacity=AA_EDGE_CAPACITY)
    if case == "s1-error-persp-windows":
        f.update(perspective_correct=True)
        kwargs.update(aa_window=(64, 128))
    if case == "s1-nonstrict-tiled":
        f.update(strict_edge=False)
        kwargs.update(tiling=port.TilingConfig(**TILING), aa_tex_plan=port.EdgeTexPlan())
    error_mode = "error" in case
    names = ("ij", "colors", "uv", "shade", "texture", "depths")
    outs = {}
    for device in ("cpu", cuda_device):
        scene = port.scene_buffers_from_numpy(f, device=device, dtype=dtype)
        obs = torch.from_numpy(np.random.RandomState(1).rand(HEIGHT, WIDTH, 3)).to(device, dtype)
        leaves = {k: getattr(scene, k).clone().requires_grad_(True) for k in names}
        kernels.reset_launches()
        img, zb, err = port.render_scene(dataclasses.replace(scene, **leaves), sigma, antialiase_error=error_mode,
                                         obs=obs, **kwargs)
        out = err if error_mode else img
        grads = torch.autograd.grad((out * out).sum(), list(leaves.values()), allow_unused=True)
        if device != "cpu":
            assert all(t.device.type == "cuda" for t in (out, zb) + tuple(g for g in grads if g is not None))
            if "tiled" in case:
                assert kernels.LAUNCHES["raster_fwd"] == 1 and kernels.LAUNCHES["edge_tex_fwd"] == 1
        outs[device if device == "cpu" else "cuda"] = [out.detach().cpu(), zb.cpu()] + [
            None if g is None else g.cpu() for g in grads]
    lim_o, lim_g = (1e-9, 1e-9) if dtype == torch.float64 else (1e-4, 1e-3)
    a, b = outs["cuda"], outs["cpu"]
    fin = torch.isfinite(b[1])
    assert torch.equal(torch.isfinite(a[1]), fin)
    assert float((a[1][fin] - b[1][fin]).abs().max()) <= (1e-9 if dtype == torch.float64 else 1e-5)
    assert float((a[0] - b[0]).abs().max()) <= lim_o
    for name, ga, gb in zip(names, a[2:], b[2:]):
        assert (ga is None) == (gb is None), name
        if gb is not None:
            assert _rel(ga, gb) <= lim_g, name


@pytest.mark.parametrize("tile_h", [8, 16, 32, 48])
@pytest.mark.parametrize("error_mode", [False, True], ids=["image", "error"])
@pytest.mark.parametrize("c", [1, 2, 3, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_edge_fwd_kernel_matches_plain_version(cuda_device, dtype, c, error_mode, tile_h):
    """B2f against its plain version on the synthetic edge tables (tiles of
    0, 1, 31, 33, 65, 70 slots, one at the capacity and one above it):
    within 1e-4 (float64: 1e-12), from a NaN-filled allocator block, one
    launch per call."""
    from deodr_tpu_torch.ops import kernels
    from deodr_tpu_torch.ops.kernels import edge_kernel as ek
    from torch_port_scenes import synthetic_edge_tables

    lim = 1e-12 if dtype == torch.float64 else 1e-4
    table, _, buf0, final, z_pad, obs_pad, counts, grid = synthetic_edge_tables(tile_h, c, error_mode, False, dtype,
                                                                                cuda_device)
    assert bool((final != buf0).any())
    _prefill_allocator(final.numel(), dtype, cuda_device)
    kernels.reset_launches()
    out = ek.edge_fwd(table, buf0, z_pad, obs_pad, counts, grid, error_mode)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["edge_fwd"] == 1
    assert float((out - final).abs().max()) <= lim


@pytest.mark.parametrize("tile_h", [8, 16, 32, 48])
@pytest.mark.parametrize("error_mode", [False, True], ids=["image", "error"])
@pytest.mark.parametrize("c", [1, 2, 3, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_edge_tex_fwd_kernel_matches_plain_version(cuda_device, dtype, c, error_mode, tile_h):
    """B3f against its plain version on the textured synthetic edge tables
    (tiles of 0, 1, 31, 33, 65, 70 slots, one at the capacity and one above
    it; about half the slots textured with uv past the texture's borders,
    the others plain with NaN uv): within 1e-4 (float64: 1e-12), from a
    NaN-filled allocator block, one launch per call."""
    from deodr_tpu_torch.ops import kernels
    from deodr_tpu_torch.ops.kernels import edge_tex_kernel as etk
    from torch_port_scenes import synthetic_edge_tables

    lim = 1e-12 if dtype == torch.float64 else 1e-4
    table, texture, buf0, final, z_pad, obs_pad, counts, grid = synthetic_edge_tables(tile_h, c, error_mode, True,
                                                                                      dtype, cuda_device)
    assert bool((final != buf0).any())
    _prefill_allocator(final.numel(), dtype, cuda_device)
    kernels.reset_launches()
    out = etk.edge_tex_fwd(table, texture, buf0, z_pad, obs_pad, counts, grid, error_mode)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["edge_tex_fwd"] == 1
    assert float((out - final).abs().max()) <= lim


# the quads a block of B4f takes (kQuadFwdThreads = 64 in csrc/quad_blend_kernel.cu, a thread a pixel)
QUAD_FWD_BLOCK_QUADS = 16


@pytest.mark.parametrize("q", [1, 31, 33, 300, QUAD_FWD_BLOCK_QUADS + 1])
@pytest.mark.parametrize("c", [1, 2, 3, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_quad_blend_fwd_kernel_matches_plain_version(cuda_device, dtype, c, q):
    """B4f at every channel count, at Q of one quad, under and over a warp's
    and a block's quads, with tap offsets beyond 0..6 (clamped at 0 and 6)
    and weights of 0 and 1: equal to its plain version bit for bit (the
    same operation order, -fmad=false), from a NaN-filled allocator block,
    one launch per call."""
    from deodr_tpu_torch.ops import kernels
    from deodr_tpu_torch.ops.kernels import quad_blend_kernel as qbk

    rng = np.random.RandomState(100 * c + q)
    win = torch.from_numpy(rng.randn(q, 64 * c)).to(cuda_device, dtype)
    dv = torch.from_numpy(rng.randint(-3, 10, (q, 4)).astype(np.int32)).to(cuda_device)
    du = torch.from_numpy(rng.randint(-3, 10, (q, 4)).astype(np.int32)).to(cuda_device)
    ev = torch.from_numpy(rng.rand(q, 4)).to(cuda_device, dtype)
    eu = torch.from_numpy(rng.rand(q, 4)).to(cuda_device, dtype)
    dv[0, :2], du[0, :2], ev[0, :2], eu[0, 2:] = 6, 0, 0.0, 1.0
    args = (win, dv, du, ev, eu)
    want = qbk.quad_blend_fwd(*args, impl="reference")
    _prefill_allocator(want.numel(), dtype, cuda_device)
    kernels.reset_launches()
    got = qbk.quad_blend_fwd(*args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["quad_blend_fwd"] == 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("kernel", ["raster", "edge", "edge_tex"])
def test_fwd_launchers_refuse_another_shape(cuda_device, kernel, monkeypatch):
    """A forward kernel's entry point takes only the shape its launch-shape
    helper gives: one more thread group, block or 8 bytes of shared memory
    is refused with an error, and nothing is launched."""
    from deodr_tpu_torch.ops import kernels
    from deodr_tpu_torch.ops.kernels import edge_kernel as ek
    from deodr_tpu_torch.ops.kernels import edge_tex_kernel as etk
    from deodr_tpu_torch.ops.kernels import raster_kernel as rk
    from torch_port_scenes import synthetic_edge_tables, synthetic_raster_tables

    if kernel == "raster":
        setup, affine, counts, grid = synthetic_raster_tables(16, 3, torch.float32, cuda_device)
        module, helper = rk, "raster_fwd_launch_shape"
        call = lambda: rk.raster_fwd(setup, affine, counts, grid)  # noqa: E731
    elif kernel == "edge_tex":
        table, texture, buf0, _, z_pad, obs_pad, counts, grid = synthetic_edge_tables(16, 3, False, True,
                                                                                      torch.float32, cuda_device)
        module, helper = etk, "edge_tex_fwd_launch_shape"
        call = lambda: etk.edge_tex_fwd(table, texture, buf0, z_pad, obs_pad, counts, grid, False)  # noqa: E731
    else:
        table, _, buf0, _, z_pad, obs_pad, counts, grid = synthetic_edge_tables(16, 3, False, False, torch.float32,
                                                                                cuda_device)
        module, helper = ek, "edge_fwd_launch_shape"
        call = lambda: ek.edge_fwd(table, buf0, z_pad, obs_pad, counts, grid, False)  # noqa: E731
    call()
    shape = getattr(module, helper)
    for change in (dict(threads=32), dict(blocks_per_tile=1), dict(smem_bytes=8)):
        def wrong(*a, change=change):
            s = shape(*a)
            return s._replace(**{k: getattr(s, k) + v for k, v in change.items()})

        monkeypatch.setattr(module, helper, wrong)
        kernels.reset_launches()
        with pytest.raises(RuntimeError, match="kernel failed"):
            call()
        assert sum(kernels.LAUNCHES.values()) == 0


def test_projection_ignores_tf32(cuda_device):
    """With TF32 on for matrix products, the float32 projection of the
    duck's vertices through the duck's camera matches the float64 one within
    1e-3 px: the camera's products cannot take TF32."""
    from deodr_tpu_torch import data_path
    from deodr_tpu_torch import duck_scene as ds
    from deodr_tpu_torch.camera import default_camera, project_points_arrays
    from deodr_tpu_torch.geometry.mesh import ColoredTriMesh

    mesh = ColoredTriMesh.load(os.path.join(data_path, "duck.obj"))
    camera = default_camera(ds.DUCK_WIDTH, ds.DUCK_HEIGHT, 60, mesh.vertices.numpy(), np.diag([1.0, -1.0, -1.0]))
    out = {}
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        for dtype in (torch.float32, torch.float64):
            def t(a):
                return torch.as_tensor(a, dtype=dtype, device=cuda_device)

            out[dtype], _ = project_points_arrays(t(camera.extrinsic), t(camera.intrinsic), None, t(mesh.vertices))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    assert float((out[torch.float32].double() - out[torch.float64]).abs().max()) <= 1e-3


def _make_fitter(fit, device, dtype):
    from deodr_tpu_torch.examples import depth_image_hand_fitting, rgb_image_hand_fitting, rgb_multiview_hand

    module = {"depth": depth_image_hand_fitting, "rgb": rgb_image_hand_fitting, "multiview": rgb_multiview_hand}[fit]
    return module.make_fitter(device=device, dtype=dtype)


def _steps(fitter, n):
    import contextlib
    import io

    with contextlib.redirect_stdout(io.StringIO()):
        return [fitter.step()[0] for _ in range(n)]


@pytest.mark.parametrize("fit", ["depth", "rgb"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_kernels_match_plain_versions_at_the_fitters_shapes(cuda_device, dtype, fit):
    """B1 and B2, forward and backward, against their plain versions on the
    tables of a depth-fit step (200×200, one channel) and an RGB-fit step
    (200 wide × 199 high, 3 channels), with the fitter's own plan: slot_map
    exact, z within 1e-5, images within 1e-4, gradient tables within 1e-3
    of their scale (chip_smoke.py's bounds); every kernel launched by the
    step, and no other."""
    import chip_smoke
    from deodr_tpu_torch.ops import kernels

    fitter = _make_fitter(fit, cuda_device, dtype)
    kernels.reset_launches()
    _steps(fitter, 1)
    launched = {k: v for k, v in kernels.LAUNCHES.items() if v}
    assert launched == dict.fromkeys(chip_smoke.FITTER_KERNELS, fitter.core.n_runs), launched
    chip_smoke.fitter_kernels(fitter, cuda_device, print, fit)


@pytest.mark.parametrize("fit", ["depth", "rgb", "multiview"])
def test_fitter_step_on_the_card_matches_the_cpu(cuda_device, fit):
    """Two fitter steps on the card in float64 against the same steps on
    the CPU: energies within 1e-9 relative, the optimizer state within 1e-9
    of its scale (the plain versions and the kernels agree to the last bits;
    the Laplacian's atomics change only the last bits)."""
    from deodr_tpu_torch.checkpoint import _FITTER_STATE_KEYS

    runs = {}
    for device in ("cpu", cuda_device):
        fitter = _make_fitter(fit, device, torch.float64)
        energies = _steps(fitter, 2)
        runs[str(device)] = energies, {k: np.array(getattr(fitter, k)) for k in _FITTER_STATE_KEYS
                                       if hasattr(fitter, k)}
    (e_cpu, s_cpu), (e_card, s_card) = runs["cpu"], runs[str(cuda_device)]
    assert all(abs(a - b) <= 1e-9 * abs(b) for a, b in zip(e_card, e_cpu)), (e_card, e_cpu)
    for k in s_cpu:
        assert np.abs(s_card[k] - s_cpu[k]).max() <= 1e-9 * max(1.0, float(np.abs(s_cpu[k]).max())), k


def _soup_scenes(device, n_tri, clockwise=False):
    """The triangle soup of deodr_tpu_torch.examples.triangle_soup_fitting
    (seed 2) with ``n_tri`` triangles at 200×200 on ``device``, with the
    kernels and with the plain versions."""
    from deodr_tpu_torch.examples.triangle_soup_fitting import create_example_scene, create_scene_copy

    np.random.seed(2)
    scene = create_example_scene(n_tri=n_tri, clockwise=clockwise, textured_ratio=0.0, device=device)
    reference = create_scene_copy(scene)
    reference.impl = "reference"
    return scene, reference


@pytest.mark.parametrize("antialiase_error", [False, True])
def test_scene2d_on_the_card_matches_the_cpu(cuda_device, antialiase_error):
    """Scene2D's render_compare_and_backward on the triangle soup (untiled,
    textured and plain triangles, σ = 1) on the card against the CPU, both
    float64: image, z, error and every gradient buffer within 1e-9 of their
    scale; no hand kernel launched (the untiled route is plain PyTorch)."""
    from deodr_tpu_torch.examples.triangle_soup_fitting import SoupFit
    from deodr_tpu_torch.ops import kernels

    fits = {str(d): SoupFit(antialiase_error=antialiase_error, device=d) for d in ("cpu", cuda_device)}
    kernels.reset_launches()
    out = {}
    for key, fit in fits.items():
        out[key] = fit.scene.render_compare_and_backward(fit.image_target, antialiase_error=antialiase_error)
    assert not any(kernels.LAUNCHES.values()), kernels.LAUNCHES
    want, got = out["cpu"], out[str(cuda_device)]
    for a, b in list(zip(got[:3], want[:3])) + [(fits[str(cuda_device)].scene.ij_b, fits["cpu"].scene.ij_b),
                                                (fits[str(cuda_device)].scene.texture_b, fits["cpu"].scene.texture_b)]:
        fin = np.isfinite(b)
        assert np.array_equal(fin, np.isfinite(a))
        assert np.abs(a[fin] - b[fin]).max() <= 1e-9 * max(1.0, np.abs(b[fin]).max())


@pytest.mark.parametrize("textured", [False, True])
@pytest.mark.parametrize("antialiase_error", [False, True])
def test_scene2d_tiled_kernels_match_plain_versions(cuda_device, antialiase_error, textured):
    """Scene2D above 256 faces (300 soup triangles of one color each,
    200×200, σ = 1, float64) on the tiled route: render_compare_and_backward
    with the kernels against impl="reference" on the card (image, z, error,
    ij_b and colors_b within 1e-9 of their scale). Without a texture each of
    B1 and B2 forward and backward is launched once, and no other kernel;
    with one (the soup's texture, though no triangle samples it) the edges
    take the sequential pass, as in the JAX package, which hands Scene2D no
    texture plan: B1 alone."""
    from deodr_tpu_torch.ops import kernels

    scene, reference = _soup_scenes(cuda_device, 300)
    if not textured:
        scene.texture = reference.texture = np.zeros((0, 0, 3))
    assert scene._plan_tiling(1.0) is not None
    obs = np.random.RandomState(2).rand(200, 200, 3)
    kernels.reset_launches()
    got = scene.render_compare_and_backward(obs, antialiase_error=antialiase_error)
    launched = {k: v for k, v in kernels.LAUNCHES.items() if v}
    names = ("raster_fwd", "raster_bwd") + (() if textured else ("edge_fwd", "edge_bwd"))
    assert launched == dict.fromkeys(names, 1), launched
    want = reference.render_compare_and_backward(obs, antialiase_error=antialiase_error)
    for a, b in list(zip(got[:3], want[:3])) + [(scene.ij_b, reference.ij_b), (scene.colors_b, reference.colors_b)]:
        fin = np.isfinite(b)
        assert np.array_equal(fin, np.isfinite(a))
        assert np.abs(a[fin] - b[fin]).max() <= 1e-9 * max(1.0, np.abs(b[fin]).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_render_deferred_runs_the_raster_kernel_at_d14(cuda_device, dtype):
    """render_deferred on the duck at 320×240 (tiled, σ = 0, 14 planes):
    the raster forward against its plain version on its tables (slot_map
    exact; planes within 1e-4 of scale in float32, 1e-9 in float64), the
    channels against impl="reference" on the card, one launch of the raster
    forward and no other kernel."""
    import chip_smoke
    from deodr_tpu_torch import data_path
    from deodr_tpu_torch.examples import render_mesh
    from deodr_tpu_torch.ops import kernels

    limit = 1e-4 if dtype == torch.float32 else 1e-9
    scenes = {}
    for impl in ("kernel", "reference"):
        scene, camera = render_mesh.default_scene(os.path.join(data_path, "duck.obj"), 320, 240, device=cuda_device,
                                                  dtype=dtype, impl=impl)
        scene.sigma = 0
        scenes[impl] = scene
    buffers, tiling, sizes = scenes["kernel"]._deferred_buffers(camera)
    assert buffers.colors.shape[1] == 14 and tiling is not None
    chip_smoke.check_raster_kernels(buffers, tiling, cuda_device, print, torch.Generator().manual_seed(0),
                                    limit_z=1e-5 if dtype == torch.float32 else 1e-9, limit_vals=limit,
                                    vals_of_scale=True, backward=False)
    kernels.reset_launches()
    got = scenes["kernel"].render_deferred(camera)
    assert {k: v for k, v in kernels.LAUNCHES.items() if v} == {"raster_fwd": 1}
    want = scenes["reference"].render_deferred(camera)
    for k in want:
        assert np.abs(got[k] - want[k]).max() <= limit * max(1.0, np.abs(want[k]).max()), k


@pytest.mark.parametrize("case", ["supertiles-l5-2048", "pairs-l6-1024", "pairs-l7-2048"])
def test_large_mesh_binners_match_dense_binning(cuda_device, case):
    """Scene3D on octahedron meshes through the port's planner (chip_smoke.py
    phase 9's configurations): the plan picks the binner named, a render
    with check_capacity=True raises no overflow, and render_scene on its
    buffers with the plan equals the same plan with dense binning: in
    float32 image and z within 1e-6 and the gradients to ij and colors
    within 1e-2 of scale (float atomics: two dense runs differ by up to
    1.8e-3), in float64 all within 1e-9."""
    import chip_smoke

    binner, level, res = case.split("-")[0], int(case.split("-")[1][1:]), int(case.split("-")[2])
    sigma = 0.0 if binner == "supertiles" else 1.0
    obs = None
    for dtype, lim_out, lim_grad in ((torch.float32, chip_smoke.LARGE_LIMIT_OUT, chip_smoke.LARGE_LIMIT_GRAD32),
                                     (torch.float64, chip_smoke.LARGE_LIMIT64, chip_smoke.LARGE_LIMIT64)):
        scene, camera = chip_smoke.large_scene(level, res, sigma, cuda_device, dtype)
        plan = scene._eager_plan(camera)
        tiling = plan[1]
        assert (tiling.super_capacity > 0) if binner == "supertiles" else (tiling.pair_ry * tiling.pair_rx > 0)
        image = scene.render(camera, check_capacity=True)
        obs = (image + 0.05).clamp(0.0, 1.0) if obs is None else obs.to(dtype)
        buffers = chip_smoke.large_buffers(scene, camera)
        chip_smoke.check_against(f"{case} {dtype}",
                                 chip_smoke.large_loss_grads(buffers, sigma, plan, obs, check_capacity=True),
                                 chip_smoke.large_loss_grads(buffers, sigma, chip_smoke.dense_plan(plan), obs), print,
                                 lim_out, lim_out, lim_grad)


@pytest.mark.parametrize("case", ["planes-d14-cap1024", "slots-d1-cap16384"])
def test_raster_bwd_split_matches_plain_version(cuda_device, case):
    """B1b where one launch's table does not fit a block's shared memory, in
    float64: the batched launches (two plane batches at D = 14 and capacity
    1024; two slot windows at D = 1 and capacity 16384) against the plain
    version within 1e-9 of scale, one launch a batch, every entry written
    (a NaN-filled block waits in the allocator) and rows at or above a
    tile's count exactly 0."""
    from deodr_tpu_torch.ops import kernels
    from deodr_tpu_torch.ops.kernels import TileGrid
    from deodr_tpu_torch.ops.kernels import raster_kernel as rk

    d, cap = (14, 1024) if case.startswith("planes") else (1, 16384)
    grid = TileGrid(2, 3, 16, 128)
    rng = np.random.RandomState(11)
    hp, wp = grid.padded_hw
    slot_map = torch.from_numpy(rng.randint(0, cap + 1, (hp, wp)).astype(np.int32)).to(cuda_device)
    counts = torch.tensor([0, cap + 5, cap, cap // 2, 7, cap - 1], dtype=torch.int32, device=cuda_device)
    g_vals = torch.from_numpy(rng.randn(d, hp, wp)).to(cuda_device)
    batches = rk.raster_bwd_batches(cap, d, 8)
    assert len(batches) == 2
    want = rk.raster_bwd(slot_map, g_vals, counts, grid, cap, impl="reference")
    _prefill_allocator(want.numel(), torch.float64, cuda_device)
    kernels.reset_launches()
    got = rk.raster_bwd(slot_map, g_vals, counts, grid, cap)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["raster_bwd"] == len(batches)
    assert bool(torch.isfinite(got).all())
    for t, n in enumerate(counts.clamp(max=cap).tolist()):
        assert bool((got[t, n:] == 0).all()), t
    assert float(want.abs().max()) > 0 and _rel(got, want) <= 1e-9


def test_second_backward_on_the_card(cuda_device):
    """Two render_backward calls after one render on the card, float64,
    against the same calls on the CPU (1e-9 of scale): Scene3D on the
    textured torus of tests/torch_port_scenes.py (tiled, kernels) stores
    each call's gradients; Scene2D on the triangle soup (untiled) adds
    them."""
    from deodr_tpu_torch.camera import Camera
    from deodr_tpu_torch.examples import triangle_soup_fitting as soup
    from deodr_tpu_torch.geometry.mesh import ColoredTriMesh
    from deodr_tpu_torch.scene import Scene3D
    from torch_port_scenes import torus_arrays, torus_camera_arrays

    a = torus_arrays(tex_size=64, uv_step=(3.5, 4.5))
    extrinsic, intrinsic, height, width = torus_camera_arrays()
    camera = Camera(extrinsic, intrinsic, height, width)
    rng = np.random.RandomState(3)
    cots = [rng.rand(height, width, 3) for _ in range(2)]
    got = {}
    for device, impl in ((cuda_device, "kernel"), (torch.device("cpu"), "reference")):
        kw = {k: v for k, v in a.items() if k not in ("faces", "vertices")}
        mesh = ColoredTriMesh(a["faces"], torch.from_numpy(a["vertices"]).to(device), **kw)
        mesh.uv, mesh.texture = mesh.uv.to(device), mesh.texture.to(device)
        scene = Scene3D(sigma=1.0, device=device, impl=impl)
        scene.set_mesh(mesh)
        scene.set_light(np.array([-0.4, -0.4, -0.8]), 0.4)
        scene.set_background_color(np.array([0.2, 0.3, 0.5]))
        scene.render(camera)
        out = []
        for cot in cots:
            scene.render_backward(cot)
            out.append([x.cpu() for x in (mesh._vertices_b, mesh.uv_b, mesh.texture_b, scene.light_directional_b)])
        got[device.type] = out
    for k in range(2):
        for x, y in zip(got["cuda"][k], got["cpu"][k]):
            assert _rel(x, y) <= 1e-9
    assert _rel(got["cuda"][0][0], got["cuda"][1][0]) > 1e-6  # two cotangents, two sets of gradients

    grads = {}
    soup_cots = [rng.rand(200, 200, 3) for _ in range(2)]
    for device in (cuda_device, torch.device("cpu")):
        np.random.seed(2)
        scene = soup.create_example_scene(device=device)
        scene.clear_gradients()
        scene.render(sigma=1)
        for cot in soup_cots:
            scene.render_backward(cot)
        grads[device.type] = (scene.ij_b.copy(), scene.colors_b.copy())
    for x, y in zip(grads["cuda"], grads["cpu"]):
        assert np.abs(x - y).max() <= 1e-9 * max(1.0, np.abs(y).max())


# ------------------------------------------------------------ scale-out and auxiliaries


def test_tile_sharded_render_world_size_1_nccl_equals_render_scene(cuda_device):
    """One NCCL rank: the band is the frame, so image and z are bit-equal to
    render_scene's (float64); the gradients differ only by the order of the
    raster backward's atomic sums (1e-12 of scale). The scene is textured
    and has no EdgeTexPlan, so its edges take the sequential pass: the
    raster kernels run, the edge kernels do not."""
    import torch_port_dist as workers
    from deodr_tpu_torch.parallel import run_ranks

    fields = workers.production_scene_fields()
    want = workers.single_render(fields, 1.0, 64, workers.PRODUCTION_TILING, device="cuda")
    (got,) = run_ranks(workers.tile_sharded, 1, (fields, 1.0, 64, workers.PRODUCTION_TILING, "cuda"),
                       backend="nccl", device="cuda")
    assert np.array_equal(got["image"], want["image"]) and np.array_equal(got["z"], want["z"])
    for k in ("g_ij", "g_colors"):
        assert np.abs(got[k] - want[k]).max() <= 1e-12 * max(1.0, np.abs(want[k]).max())
    assert got["launches"]["raster_fwd"] == got["launches"]["raster_bwd"] == 1


def test_tile_sharded_render_two_gloo_ranks_on_one_card(cuda_device):
    """Two gloo ranks share the card: float64 image, z and gradients within
    1e-9 (of scale) of the single-process render, one all-gather forward,
    one all-reduce of the ij and colors gradients backward, the raster
    kernels launched in each rank (the textured edges take the sequential
    pass)."""
    import torch_port_dist as workers
    from deodr_tpu_torch.parallel import run_ranks

    fields = workers.production_scene_fields()
    want = workers.single_render(fields, 1.0, 64, workers.PRODUCTION_TILING, device="cuda")
    for got in run_ranks(workers.tile_sharded, 2, (fields, 1.0, 64, workers.PRODUCTION_TILING, "cuda"),
                         backend="gloo", device="cuda"):
        assert np.abs(got["image"] - want["image"]).max() <= 1e-9
        fin = np.isfinite(want["z"])
        assert np.array_equal(fin, np.isfinite(got["z"])) and np.abs(got["z"][fin] - want["z"][fin]).max() <= 1e-9
        for k in ("g_ij", "g_colors"):
            assert np.abs(got[k] - want[k]).max() <= 1e-9 * max(1.0, np.abs(want[k]).max())
        assert [c[0] for c in got["forward"]] == ["all_gather"] and [c[0] for c in got["backward"]] == ["all_reduce"]
        assert got["launches"]["raster_fwd"] == got["launches"]["raster_bwd"] == 1


def test_textured_multiview_step_two_ranks_on_one_card(cuda_device):
    """The textured multi-view step on the kernel route (B1, B3) over two
    gloo ranks against the sequential sum of its four views' gradients, in
    float64 (1e-9 of scale); one all-reduce of texture + uv + shade + loss."""
    import dataclasses

    import torch_port_dist as workers
    from deodr_tpu_torch import EdgeTexPlan, TilingConfig, render_scene, scene_buffers_from_numpy
    from deodr_tpu_torch.parallel import run_ranks

    fields = workers.production_scene_fields()
    plan = (TilingConfig(**workers.PRODUCTION_TILING), EdgeTexPlan())
    rng = np.random.RandomState(3)
    ij = fields["ij"][None] + rng.randn(4, *fields["ij"].shape) * 0.1
    obs = rng.rand(4, fields["height"], fields["width"], 3)
    params = {k: fields[k] for k in ("texture", "uv", "shade")}
    lr = 1e-3
    buffers = scene_buffers_from_numpy(fields, device="cuda")
    leaves = {k: torch.from_numpy(v).cuda().requires_grad_(True) for k, v in params.items()}
    loss = 0.0
    for v in range(4):
        img, _, _ = render_scene(dataclasses.replace(buffers, ij=torch.from_numpy(ij[v]).cuda(), **leaves), 1.0,
                                 aa_edge_capacity=64, tiling=plan[0], aa_tex_plan=plan[1])
        loss = loss + ((img - torch.from_numpy(obs[v]).cuda()) ** 2).sum()
    loss.backward()
    for got in run_ranks(workers.textured_multiview, 2, (fields, ij, obs, params, lr, 1.0, 64, 1, "cuda", plan),
                         backend="gloo", device="cuda"):
        assert abs(got["losses"][0] - float(loss)) <= 1e-9 * float(loss)
        for k, p in params.items():
            assert _rel(torch.from_numpy((p - got["params"][k]) / lr), leaves[k].grad.cpu()) <= 1e-9, k
        n_bytes = (sum(p.size for p in params.values()) + 1) * 8
        assert [c[:2] for c in got["collectives"]] == [("all_reduce", n_bytes)]
        assert all(got["launches"][k] == 2 for k in ("raster_fwd", "raster_bwd", "edge_tex_fwd", "edge_tex_bwd"))


def test_view_sharded_fitter_two_ranks_on_one_card(cuda_device):
    """The multi-frame fitter on octahedron_mesh(3) (512 faces: the tiled
    route, B1 and B2), 4 frames over two gloo ranks, 3 steps against the
    sequential fitter on the card (tests/test_parallel.py's tolerances)."""
    import torch_port_dist as workers
    from deodr_tpu_torch.parallel import run_ranks

    want = workers.sequential_fitter(4, 48, 64, 3, device="cuda", level=3)
    for got in run_ranks(workers.sharded_fitter, 2, (4, 48, 64, 3, "cuda", 3), backend="gloo", device="cuda"):
        np.testing.assert_allclose(got["energies"], want["energies"], rtol=1e-9)
        np.testing.assert_allclose(got["state"]["vertices"], want["state"]["vertices"], rtol=0, atol=1e-10)
        for k in ("quaternion", "mesh_color", "light_directional"):
            np.testing.assert_allclose(got["state"][k], want["state"][k], atol=1e-12, err_msg=k)
        assert all(got["launches"][k] > 0 for k in ("raster_fwd", "raster_bwd", "edge_fwd", "edge_bwd"))


def test_batch_matches_single_renders(cuda_device):
    """render_scene_batch on the kernel route: each scene's image bit-equal
    to its single render, gradients within 1e-9 of scale (float64: only the
    atomics' order differs), each kernel launched once per scene."""
    import dataclasses

    import torch_port_dist as workers
    from deodr_tpu_torch import TilingConfig, render_scene, render_scene_batch, scene_buffers_from_numpy
    from deodr_tpu_torch.ops import kernels

    fields = workers.production_scene_fields()
    scene = scene_buffers_from_numpy(fields, device="cuda")
    tiling = TilingConfig(**workers.PRODUCTION_TILING)
    rng = np.random.RandomState(0)
    ij = torch.from_numpy(fields["ij"][None] + rng.randn(4, *fields["ij"].shape) * 0.5).cuda().requires_grad_(True)
    kernels.reset_launches()
    images, _, _ = render_scene_batch(dataclasses.replace(scene, ij=ij, texture=None), 1.0, aa_edge_capacity=64,
                                      tiling=tiling)
    (images ** 2).sum().backward()
    assert all(kernels.LAUNCHES[k] == 4 for k in ("raster_fwd", "raster_bwd", "edge_fwd", "edge_bwd"))
    for b in range(4):
        leaf = ij[b].detach().clone().requires_grad_(True)
        img, _, _ = render_scene(dataclasses.replace(scene, ij=leaf, texture=None), 1.0, aa_edge_capacity=64,
                                 tiling=tiling)
        (img ** 2).sum().backward()
        assert torch.equal(img.detach(), images[b].detach())
        assert _rel(ij.grad[b], leaf.grad) <= 1e-9


def test_device_profile_names_the_kernels_of_a_bench_step(cuda_device):
    """device_profile around one bench fwd+bwd at σ = 1: B1f, B1b, B2f and
    B2b each once, and a busy time no larger than the sum of the
    operations' times."""
    import chip_smoke
    from deodr_tpu_torch.profiling import device_profile

    _, scene, tiling, obs = chip_smoke.bench_setup(cuda_device, 144, 256, 40)
    chip_smoke.single_bench(scene, tiling, obs)
    with device_profile() as prof:
        chip_smoke.single_bench(scene, tiling, obs)
    for name in ("raster_fwd_kernel", "raster_bwd_kernel", "edge_fwd_kernel", "edge_bwd_kernel"):
        assert sum(n for op, n in prof.counts.items() if name in op) == 1, (name, prof.report(top=50))
    assert 0 < prof.total_us <= sum(prof.times.values()) + 1e-6
    assert prof.report().startswith("device total:")


@pytest.mark.parametrize("sigma", [0.0, 1.0])
def test_degenerate_geometry_through_the_kernels(cuda_device, sigma):
    """tests/test_degenerate_gradients.py's contract on the tiled kernel
    route (float32): finite loss and gradients, the healthy triangle still
    differentiated, the barycentric flags [True, False, False, False], and
    the kernels launched."""
    import dataclasses

    from deodr_tpu_torch import TilingConfig, render_scene, scene_buffers_from_numpy
    from deodr_tpu_torch.ops import kernels
    from deodr_tpu_torch.ops.common import safe_barycentric_matrices
    from torch_port_scenes import degenerate_scene_fields

    scene = scene_buffers_from_numpy(degenerate_scene_fields(sigma), device="cuda", dtype=torch.float32)
    _, valid = safe_barycentric_matrices(scene.ij.reshape(4, 3, 2))
    assert valid.cpu().tolist() == [True, False, False, False]
    ij = scene.ij.clone().requires_grad_(True)
    kernels.reset_launches()
    img, _, _ = render_scene(dataclasses.replace(scene, ij=ij), sigma, tiling=TilingConfig(16, 128, 16, 8))
    loss = (img ** 2).sum()
    (g,) = torch.autograd.grad(loss, (ij,))
    assert bool(torch.isfinite(loss)) and bool(torch.isfinite(g).all())
    assert float(g[:3].abs().max()) > 0
    names = ("raster_fwd", "raster_bwd") + (("edge_fwd", "edge_bwd") if sigma > 0 else ())
    assert all(kernels.LAUNCHES[k] == 1 for k in names)


@pytest.mark.parametrize("tag", ["duck", "hand"])
def test_scene3d_torch_on_the_kernels(cuda_device, tag):
    """chip_smoke.py's phase 11a/b: Scene3DTorch with the kernels (B1 and B3
    on the duck, B1 and B2 on the hand, each launched) against
    impl="reference" in float32, and in float64 against the port's Scene3D
    on the same mesh, camera and lights (1e-9 of scale)."""
    import chip_smoke

    def duck(device, dtype):
        return chip_smoke.surface_duck(device, dtype) + (None,)

    scene_data, names = {
        "duck": (duck, ("raster_fwd", "raster_bwd", "edge_tex_fwd", "edge_tex_bwd")),
        "hand": (chip_smoke.surface_hand, chip_smoke.UNTEXTURED_KERNELS),
    }[tag]
    chip_smoke.run_surface_scene(tag, scene_data, cuda_device, print, names)


def test_render_scene_torch_is_render_scene_on_the_card(cuda_device):
    """chip_smoke.py's phase 11c: render_scene_torch on the hand's float64
    buffers against render_scene on plan_tiling's plan (image bit-equal,
    gradients within 1e-12 of scale), B1 and B2 launched."""
    import chip_smoke

    hand = chip_smoke.run_surface_scene("hand", chip_smoke.surface_hand, cuda_device, print,
                                        chip_smoke.UNTEXTURED_KERNELS)
    chip_smoke.run_bridge(hand, cuda_device, print)
