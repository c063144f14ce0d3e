"""Scenes and kernel inputs shared by the port's textured tests: numpy
fields made from a seed and the kernel tables the port makes of them. Nothing here
imports JAX, so the card-only tests can use it too."""

import numpy as np
import torch

import deodr_tpu_torch as port
from deodr_tpu_torch.ops.edge_aa import EdgeAAConfig
from deodr_tpu_torch.ops.render import _build_edge_data, prepare, scene_buffers_from_numpy
from deodr_tpu_torch.ops.tiled import (
    compact_active_edges,
    edge_tables,
    pad_edge_buffers,
    rasterize_tiled_kernel,
    split_edges,
)

# Run under pytest-xdist, every worker process imports this module at
# collection. PyTorch's intra-op pool has a thread per core in each worker,
# so several workers oversubscribe the cores, and the port's tests (many
# small operations: the sequential edge pass runs ~200 an edge) spend their
# time waiting on each other's threads. One thread a worker keeps each
# test near its time alone.
torch.set_num_threads(1)

HEIGHT, WIDTH = 96, 128
SIGMA = 1.5
TILING = dict(tile_h=32, tile_w=128, triangle_capacity=48, edge_capacity=64)
AA_EDGE_CAPACITY = 64
_SPLIT = dict(n_split=8, seg_capacity=128, uv_segment_length=12.0)
# the texture window of the JAX package's EdgeTexPlan, which the port's plan has no field for
JAX_WINDOW = dict(win_h=16, win_w=16)
# name → (arguments of mixed_scene_fields, fields of the EdgeTexPlan). "clamped" puts the split scene's
# uv (2 to 42) on an 8×8 texture, so most band pixels sample beyond its right and bottom borders
PLANS = {
    "unsplit": (dict(seed=0, uv_scale=8.0), dict(n_split=1)),
    "split": (dict(seed=3, uv_scale=40.0), _SPLIT),
    "clamped": (dict(seed=3, uv_scale=40.0, tex_hw=(8, 8)), _SPLIT),
}


def mixed_scene_fields(n_tri=12, tex_hw=(64, 64), seed=0, uv_scale=8.0, tilt=0.0) -> dict:
    """The mixed textured / plain triangle soup of
    tests/test_edge_tex_pallas.py::make_scene, as numpy fields. ``tilt`` > 0
    adds up to that much depth per vertex, so that the triangles are not
    parallel to the image plane: a band's depth then differs from its own
    triangle's wherever both reach a pixel (with ``strict_edge=False`` a
    triangle clipped at the frame's border covers pixels outside its edges,
    and at equal depths the z-test would be decided by the last bit)."""
    rng = np.random.RandomState(seed)
    centers = rng.rand(n_tri, 1, 2) * [WIDTH, HEIGHT]
    tri = centers + (rng.rand(n_tri, 3, 2) - 0.5) * 60
    u = tri[:, 1] - tri[:, 0]
    w = tri[:, 2] - tri[:, 0]
    raw = u[:, 0] * w[:, 1] - w[:, 0] * u[:, 1]
    tri[raw > 0] = tri[raw > 0][:, [0, 2, 1]]
    faces = np.arange(3 * n_tri, dtype=np.int32).reshape(n_tri, 3)
    depths = np.repeat(rng.rand(n_tri), 3) + 0.5
    colors = rng.rand(3 * n_tri, 3)
    uv = rng.rand(3 * n_tri, 2) * uv_scale + 2.0
    shade = rng.rand(3 * n_tri) * 0.8 + 0.2
    texture = rng.rand(*tex_hw, 3)
    textured = rng.rand(n_tri) < 0.6
    if tilt:
        depths = depths + tilt * np.random.RandomState(seed + 1000).rand(3 * n_tri)
    return dict(
        faces=faces, faces_uv=faces, ij=tri.reshape(-1, 2), depths=depths, uv=uv, shade=shade, colors=colors,
        edgeflags=np.ones((n_tri, 3), bool), textured=textured, shaded=np.ones((n_tri,), bool), texture=texture,
        background_image=None, background_color=np.array([0.3, 0.5, 0.7]), height=HEIGHT, width=WIDTH,
        clockwise=False, backface_culling=True, strict_edge=True, perspective_correct=False,
        integer_pixel_centers=True,
    )


def plan_scene(plan):
    """(numpy scene fields, EdgeTexPlan fields) of ``PLANS[plan]``."""
    scene_kw, kw = PLANS[plan]
    return mixed_scene_fields(**scene_kw), kw


def obs_image():
    return np.random.RandomState(9).rand(HEIGHT, WIDTH, 3)


def tex_tables(plan, error_mode, dtype=torch.float64, device="cpu"):
    """The textured edge kernel's inputs as the port's render path builds
    them for the mixed scene under ``PLANS[plan]`` → (EdgeTables, texture,
    buffer, z_pad, obs_pad)."""
    fields, kw = plan_scene(plan)
    scene = scene_buffers_from_numpy(fields, device=device, dtype=dtype)
    tiling = port.TilingConfig(**TILING)
    tex_plan = port.EdgeTexPlan(**kw)
    obs = torch.from_numpy(obs_image()).to(device, dtype)
    with torch.no_grad():
        ij_off, signed_area, draw, background = prepare(scene)
        image, z_buffer, _ = rasterize_tiled_kernel(scene, ij_off, draw, background, tiling, impl="reference")
        edges = _build_edge_data(scene, ij_off, signed_area, AA_EDGE_CAPACITY)
        if tex_plan.n_split > 1:
            edges = compact_active_edges(
                split_edges(edges, tex_plan.n_split, None, tex_plan.uv_segment_length), tex_plan.seg_capacity
            )
        cfg = EdgeAAConfig(HEIGHT, WIDTH, SIGMA, False, error_mode, True)
        et = edge_tables(cfg, edges, z_buffer, tiling)
        buffer = ((image - obs) ** 2).sum(-1) if error_mode else image
        buf, z_pad, obs_pad = pad_edge_buffers(cfg, buffer, z_buffer, obs, et.grid)
    return et, scene.texture, buf, z_pad, obs_pad


# ------------------------------------------------------ a textured torus (Scene3D)

TORUS_HW = (96, 128)


def torus_arrays(textured=True, n=16, m=12, tex_size=256, uv_step=(15.0, 20.0), seed=0) -> dict:
    """A closed torus of 2·n·m faces (384 by default: above the 256 faces
    under which the planner gives no tiling) as numpy arrays for the
    ``ColoredTriMesh`` of either package: ``faces``, ``vertices`` (jittered
    from a seed), ``clockwise`` and either ``faces_uv``, ``uv`` (``uv_step``
    texels per segment around and across, with a seam where the parameter
    wraps; the default steps give silhouette edges longer than 12 texels,
    which the planner splits) and a ``tex_size``² ``texture``, or per-vertex
    ``colors``."""
    rng = np.random.RandomState(seed)
    theta = 2 * np.pi * np.arange(n) / n
    phi = 2 * np.pi * np.arange(m) / m
    tt, pp = np.meshgrid(theta, phi, indexing="ij")
    vertices = np.stack([(1 + 0.4 * np.cos(pp)) * np.cos(tt), (1 + 0.4 * np.cos(pp)) * np.sin(tt), 0.4 * np.sin(pp)],
                        axis=-1).reshape(-1, 3)
    vertices = vertices + rng.uniform(-0.01, 0.01, vertices.shape)
    i, j = np.meshgrid(np.arange(n), np.arange(m), indexing="ij")
    i, j = i.ravel(), j.ravel()

    def vid(a, b):
        return (a % n) * m + b % m

    def uvid(a, b):
        return a * (m + 1) + b

    faces = np.concatenate([np.stack([vid(i, j), vid(i + 1, j), vid(i + 1, j + 1)], 1),
                            np.stack([vid(i, j), vid(i + 1, j + 1), vid(i, j + 1)], 1)]).astype(np.int32)
    faces_uv = np.concatenate([np.stack([uvid(i, j), uvid(i + 1, j), uvid(i + 1, j + 1)], 1),
                               np.stack([uvid(i, j), uvid(i + 1, j + 1), uvid(i, j + 1)], 1)]).astype(np.int32)
    tri = vertices[faces]
    volume = np.einsum("ij,ij->i", tri[:, 0], np.cross(tri[:, 1], tri[:, 2])).sum()
    if volume < 0:
        faces, faces_uv = faces[:, ::-1].copy(), faces_uv[:, ::-1].copy()
    out = dict(faces=faces, vertices=vertices, clockwise=False)
    if textured:
        ui, vj = np.meshgrid(np.arange(n + 1), np.arange(m + 1), indexing="ij")
        uv = np.stack([ui.ravel() * uv_step[0] + 3.3, vj.ravel() * uv_step[1] + 2.7], axis=1)
        out.update(faces_uv=faces_uv, uv=uv, texture=rng.rand(tex_size, tex_size, 3))
    else:
        out.update(colors=rng.rand(len(vertices), 3))
    return out


def torus_camera_arrays(view=0):
    """(extrinsic, intrinsic, height, width) of an oblique view of the
    torus; ``view=1`` is the same camera turned by a few degrees."""
    a = np.deg2rad(55.0 + 4.0 * view)
    b = np.deg2rad(10.0 + 3.0 * view)
    rx = np.array([[1, 0, 0], [0, np.cos(a), -np.sin(a)], [0, np.sin(a), np.cos(a)]])
    rz = np.array([[np.cos(b), -np.sin(b), 0], [np.sin(b), np.cos(b), 0], [0, 0, 1]])
    rot = rx @ rz
    extrinsic = np.column_stack([rot, [0.013, -0.021, 4.1]])
    h, w = TORUS_HW
    intrinsic = np.array([[131.7, 0, w / 2 + 0.37], [0, 131.7, h / 2 - 0.29], [0, 0, 1]])
    return extrinsic, intrinsic, h, w


# counts of the synthetic edge tiles: none, one, just under and just over 32, more than 64 (one just over),
# exactly the capacity, and above it (clamped)
SYNTH_CAP = 72
SYNTH_COUNTS = (0, 1, 31, 33, 70, SYNTH_CAP, SYNTH_CAP + 5, 65)


def synthetic_edge_tables(tile_h, nb_colors, error_mode, textured, dtype=torch.float64, device="cpu", seed=0,
                          tex_hw=(40, 56)):
    """Edge-pass inputs on a 2 × 4 grid of tile_h × 128 tiles with the slot
    counts of SYNTH_COUNTS: each slot a random band (half-width 1-3 px,
    length 5-60 px) through a random point of its tile, T in 0.05-0.95,
    colour planes near 0.5, a z-buffer that hides a tenth of the pixels,
    a tenth of the slots inactive. With ``textured``, about half the slots
    sample a random texture over uv that runs past its borders (clamped
    taps), and the other slots carry NaN uv. Rows at or above a tile's
    count hold bands too, which would paint if a kernel read them. →
    (table_tile, texture or None, buffer0, final, z_pad, obs_pad, counts,
    grid), ``final`` being the plain forward of buffer0."""
    from deodr_tpu_torch.ops.kernels import TileGrid
    from deodr_tpu_torch.ops.kernels import edge_kernel as ek
    from deodr_tpu_torch.ops.kernels import edge_tex_kernel as etk

    rng = np.random.RandomState(seed)
    c = nb_colors
    grid = TileGrid(2, 4, tile_h, 128)
    w0 = ek.edge_row_width(c)
    width = etk.tex_row_width(c) if textured else w0
    table = np.full((grid.n_tiles, SYNTH_CAP, width), np.nan)
    for t in range(grid.n_tiles):
        ty, tx = divmod(t, grid.n_tx)
        for k in range(SYNTH_CAP):
            p0 = np.array([tx * 128 + rng.uniform(0, 128), ty * tile_h + rng.uniform(0, tile_h)])
            theta = rng.uniform(0, 2 * np.pi)
            n, d = np.array([np.cos(theta), np.sin(theta)]), np.array([-np.sin(theta), np.cos(theta)])
            half, length = rng.uniform(1, 3), rng.uniform(5, 60)
            row = table[t, k]
            for i, (vec, th) in enumerate(((n, -half), (-n, -half), (d, -length), (-d, -length))):
                row[3 * i : 3 * i + 3] = vec[0], vec[1], -vec @ p0
                row[12 + i] = th
            slope = 0.45 / half
            row[16:19] = slope * n[0], slope * n[1], 0.5 - slope * (n @ p0)
            row[19], row[20] = p0[1] - rng.uniform(2, 40), p0[1] + rng.uniform(2, 40)
            for ch in range(c):
                ax, ay = rng.normal(0, 0.01, 2)
                row[21 + 3 * ch : 24 + 3 * ch] = ax, ay, 0.5 + rng.normal(0, 0.2) - ax * p0[0] - ay * p0[1]
            row[21 + 3 * c : 24 + 3 * c] = rng.normal(0, 1e-3), rng.normal(0, 1e-3), 0.5
            row[24 + 3 * c] = float(rng.rand() > 0.1)
            if textured:
                if rng.rand() < 0.5:
                    uv0 = rng.uniform(-2, [tex_hw[1] + 1, tex_hw[0] + 1])
                    jac = rng.normal(0, 0.6, (2, 2))
                    for j, (coef, base) in enumerate(((jac[0], uv0[0]), (jac[1], uv0[1]))):
                        row[w0 + 3 * j : w0 + 3 * j + 3] = coef[0], coef[1], base - coef @ p0
                    lx, ly = rng.normal(0, 0.01, 2)
                    row[w0 + 6 : w0 + 9] = lx, ly, 0.8 - lx * p0[0] - ly * p0[1]
                    row[w0 + 9] = 1.0
                else:
                    row[w0 + 9] = 0.0  # a plain slot: its uv and shade stay NaN
    hp, wp = grid.padded_hw
    nch = 1 if error_mode else c
    buffer0 = rng.uniform(0, 1, (nch, hp, wp))
    z_pad = np.where(rng.rand(hp, wp) < 0.1, 0.3, 1.0)
    obs_pad = rng.uniform(0, 1, (c, hp, wp))
    texture = rng.uniform(0, 1, tex_hw + (c,)) if textured else None

    def tensor(a):
        return None if a is None else torch.from_numpy(np.ascontiguousarray(a)).to(device, dtype)

    table_t, tex_t, buf_t, z_t, obs_t = map(tensor, (table, texture, buffer0, z_pad, obs_pad))
    counts = torch.tensor(SYNTH_COUNTS, dtype=torch.int32, device=device)
    with torch.no_grad():
        if textured:
            final = etk.edge_tex_fwd_reference(table_t, tex_t, buf_t, z_t, obs_t, counts, grid, error_mode)
        else:
            final = ek.edge_fwd_reference(table_t, buf_t, z_t, obs_t, counts, grid, error_mode)
    return table_t, tex_t, buf_t, final, z_t, obs_t, counts, grid


# counts of the synthetic raster tiles: none, one, under a chunk, exactly one chunk (64 rows) and one slot into
# the next, many, exactly the capacity, and above it (clamped)
RASTER_CAP = 120
RASTER_COUNTS = (0, 1, 31, 64, 65, 100, RASTER_CAP, RASTER_CAP + 5)


def synthetic_raster_tables(tile_h, d=7, dtype=torch.float64, device="cpu", seed=0, strict=True, persp=False):
    """Solid-pass inputs on a 2 × 4 grid of tile_h × 128 tiles with the slot
    counts of RASTER_COUNTS, each slot a triangle's row from
    ``triangle_row_setup`` (in the coverage mode ``strict`` and the depth
    mode ``persp``, packed as ``_pack_setup_rows`` packs them): a third with
    vertices on warp-region corners (x a multiple of 16, y of 2, so pixel
    centres lie on their edges), the others 1-40 px wide around a random
    point of the tile, depths 1-10.
    Every 7th slot repeats the row 3 slots before it (equal z planes: the
    lower slot must win), one in 20 is invalid and one in 20 has a NaN
    coefficient. The last tile starts with hand-made rows: a right plane
    exactly 0 on a column of pixels, zero, denormal and infinite
    coefficients, all NaN, a NaN depth plane, and an invalid row that covers
    the tile; for non-strict rows also vertical edges (a = 0) on either
    side of the x range, and for perspective rows a depth plane through 0
    inside the tile (an infinite depth there). Rows at or above a tile's
    count hold triangles too, which would cover pixels if a kernel read
    them. → (setup_tile, affine_tile, counts, grid)"""
    from deodr_tpu_torch.ops.kernels import TileGrid
    from deodr_tpu_torch.ops.raster import triangle_row_setup
    from deodr_tpu_torch.ops.tiled import _pack_setup_rows

    rng = np.random.RandomState(seed)
    grid = TileGrid(2, 4, tile_h, 128)
    nt, cap = grid.n_tiles, RASTER_CAP
    origin = np.array([[(t % grid.n_tx) * 128, (t // grid.n_tx) * tile_h] for t in range(nt)], np.float64)
    corners = origin[:, None, None, :] + np.stack(
        [16 * rng.randint(-1, 9, (nt, cap, 3)), 2 * rng.randint(-1, tile_h // 2 + 2, (nt, cap, 3))], axis=-1)
    centre = origin[:, None, None, :] + rng.uniform(0, 1, (nt, cap, 1, 2)) * [128, tile_h]
    loose = centre + rng.uniform(-0.5, 0.5, (nt, cap, 3, 2)) * rng.uniform(1, 40, (nt, cap, 1, 1))
    v_xy = np.where(rng.rand(nt, cap, 1, 1) < 1 / 3, corners, loose).reshape(nt * cap, 3, 2)
    v_z = rng.uniform(1, 10, (nt * cap, 3))
    setup = triangle_row_setup(torch.from_numpy(v_xy), torch.from_numpy(v_z), torch.ones(nt * cap, dtype=torch.bool),
                               4 * 128, 2 * tile_h, strict, persp)
    rows = _pack_setup_rows(setup, torch.float64, strict).numpy().reshape(nt, cap, 22).copy()
    for k in range(7, cap, 7):
        rows[:, k] = rows[:, k - 3]
    rows[rng.rand(nt, cap) < 0.05, 21] = 0.0
    nan_at = rng.rand(nt, cap) < 0.05
    rows[nan_at, rng.randint(0, 22, int(nan_at.sum()))] = np.nan

    tiny = float(torch.finfo(dtype).tiny)
    den = tiny / 8  # a denormal of the dtype
    x0, y0 = origin[-1]
    whole = [y0, 1.0, y0 + tile_h - 1, 0.0]  # sub-triangle 0 spans the tile's rows, sub-triangle 1 none
    hand = [
        # x > x0 + 20.5 and a right plane exactly 0 at x = x0 + 37
        whole + [1, 0, -(x0 + 20.5), 0, 0, 0, -1, 0, x0 + 37, 0, 0, 0, x0 + 10, x0 + 60, 0, 0, 0.25, 1],
        # zero planes: left 0 > 0 never holds
        whole + [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, x0, x0 + 127, 0, 0, 0.2, 1],
        # a denormal left offset > 0, a zero right plane > −tiny: covers the x range
        whole + [0, 0, den, 0, 0, 0, 0, 0, 0, 0, 0, 0, x0 + 30, x0 + 50, 0, 0, 0.3, 1],
        # denormal slopes: x0 + 3 < x < x0 + 16 through denormal plane values
        whole + [den, 0, -den * (x0 + 3), 0, 0, 0, -den, 0, den * (x0 + 8), 0, 0, 0, x0, x0 + 127, 0, 0, 0.1, 1],
        # an infinite slope (NaN where it meets x = 0, +inf elsewhere)
        whole + [np.inf, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, x0, x0 + 127, 0, 0, 5.0, 1],
        [np.nan] * 22,
        whole + [1, 0, -x0, 0, 0, 0, -1, 0, x0 + 90, 0, 0, 0, x0, x0 + 127, np.nan, 0, 0.05, 1],
        whole + [0, 0, 1, 0, 0, 0, 0, 0, 1, 0, 0, 0, x0, x0 + 127, 0, 0, 0.01, 0],
    ]
    if not strict:
        # a = 0 edges: a left numerator −(b·y + c) < 0, = 0 and > 0, against right ones of each sign
        hand += [whole + [0, 0, c_l, 0, 0, 0, 0, 0, c_r, 0, 0, 0, x0 + 5, x0 + 70, 0, 0, 0.15, 1]
                 for c_l, c_r in ((1, 1), (0, -1), (-1, 0), (1, -1))]
    if persp:
        # the plane of 1/z crosses 0 at x = x0 + 40: negative depths left of it, +inf on it
        hand += [whole + [1, 0, -(x0 - 10), 0, 0, 0, -1, 0, x0 + 100, 0, 0, 0, x0, x0 + 127, 1, 0, -(x0 + 40), 1]]
    rows[-1, : len(hand)] = np.array(hand, np.float64)
    affine = rng.normal(0, 1, (nt, cap, 3 * d))
    counts = torch.tensor(RASTER_COUNTS, dtype=torch.int32, device=device)
    setup_t, affine_t = (torch.from_numpy(a).to(device, dtype) for a in (rows, affine))
    return setup_t, affine_t, counts, grid


def degenerate_scene_fields(sigma) -> dict:
    """tests/test_degenerate_gradients.py's scene as numpy fields (64×96,
    float32): a healthy triangle, an exactly collinear one, a sliver below
    float32 noise and a point, every edge flagged at σ > 0."""
    v0 = np.array([201.13, 140.27], np.float32)
    d = np.array([50.31, 30.77], np.float32)
    tris = [[[10.0, 10.0], [20.0, 35.0], [40.0, 12.0]], [v0, v0 + d, v0 + 2 * d],
            [v0, v0 + d, v0 + 2 * d + np.array([1e-5, -1e-5])], [v0, v0, v0]]
    n_tri = 4
    rng = np.random.RandomState(0)
    faces = np.arange(3 * n_tri, dtype=np.int32).reshape(n_tri, 3)
    return dict(
        faces=faces, faces_uv=faces, ij=np.asarray(tris, np.float32).reshape(-1, 2),
        depths=np.repeat(rng.rand(n_tri) + 0.5, 3).astype(np.float32), uv=np.zeros((3 * n_tri, 2), np.float32),
        shade=np.zeros(3 * n_tri, np.float32), colors=rng.rand(3 * n_tri, 3).astype(np.float32),
        edgeflags=np.full((n_tri, 3), sigma > 0), textured=np.zeros(n_tri, bool), shaded=np.zeros(n_tri, bool),
        texture=None, background_image=None, background_color=np.array([0.2, 0.3, 0.4], np.float32), height=64,
        width=96,
    )
