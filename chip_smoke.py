"""Smoke run of the PyTorch / CUDA port (deodr_tpu_torch) on one GPU.

Usage: ``python3 chip_smoke.py`` from the repository root, on a machine
with one CUDA card (exits non-zero, printing no result, without one).

Phases, each of which fails the run (non-zero exit) on any miss:

1. device: the card's name and ``nvidia-smi`` name / power limit;
2. build: compiles the kernels from ``deodr_tpu_torch/csrc`` (timed);
3. the untextured path on the bench scene (512², 200 triangles, 48×128
   tiles, float32). The raster and edge kernels against their plain PyTorch
   versions on the card: slot_map exact, z within 1e-5, images within 1e-4,
   gradient tables within 1e-3 of their scale (the edge backward's from two
   calls bit-identical); the (warp region, slot) pairs each forward
   kernel's cull keeps against all of them, and the (pixel, slot) pairs its
   slots cover (counted by the plain mirrors in the wrapper modules); times
   of kernel and plain version. Then
   ``render_scene`` forward + backward at σ = 0 and σ = 1, image and error
   mode, with ``check_capacity=True``, held against the
   same call with ``impl="reference"``; launch counts are zeroed just
   before and read just after. Then a 20-step gradient descent on ``ij``
   and ``colors`` towards the unperturbed render (the loss must fall), the
   median fwd+bwd step time and Mpix/s at σ = 0 and σ = 1 (CUDA events,
   after warm-up), and a ``torch.profiler`` breakdown of one σ = 1 step
   (device busy share, device operations per step, heaviest operations);
4. the textured path on the duck scene at full width (640×480, 4212 faces,
   the 512² texture, σ = 1, the plan of ``deodr_tpu_torch.duck_scene``).
   The textured edge kernel against its plain version in image and error
   mode (buffer within 1e-4, gradient rows and texture gradient within
   1e-3 of their scale: float32 atomics sum in another order; gradient rows
   from two calls bit-identical) and the
   raster kernel again with its 7 attribute planes (the cull counts of both
   forward kernels).
   Then ``render_scene``
   forward + backward with ``check_capacity=True`` against
   ``impl="reference"``: image, z-buffer and the gradients to ij, uv, shade
   and texture, with launch counts zeroed just before and read just after.
   Then a few descent steps on the duck loss of ``bench.py``
   (obs = clip(render + 0.05, 0, 1); the loss must fall), the median
   fwd+bwd step time and one profiled step;
5. ``Scene3D`` on the duck at full width, through the port's own planner
   (``deodr_tpu_torch.scene``): with ``quad_fetch=False`` the plan must equal
   the ``DUCK_*`` constants field by field, and ``render`` +
   ``render_backward`` with the kernels are held against
   ``impl="reference"`` with ``check_capacity=True`` (image, z and the
   gradients to vertices, light, uv and texture); the raster and textured
   edge kernels are held against their plain versions again, on the tables
   of the buffers ``Scene3D`` builds (float32, projected on the card), which
   the quad path shares (checked). With ``quad_fetch=True``
   the plan adds ``quad_fallback_capacity=1536``; kernel B4 (forward and
   backward) is held against its plain versions on the duck's quads
   (32256), and the quad render against the per-pixel one (image within
   1e-5, gradients within 1e-3 of their scale), with launch counts zeroed
   before and read after each path; ``torch.nn.functional.grid_sample``,
   which computes B4's function, is timed beside it as a yardstick; then the
   median step (render + render_backward) with and without the quad fetch,
   and one profiled step of each;
6. the untiled path and the remaining raster modes: (a) the bench scene
   through ``render_scene(tiling=None)`` (``find_winners``, ``shade_pixels``
   and the sequential edge pass in the windows of the planner's rule) at
   σ = 0 and 1, image and error mode, forward + backward against the same
   call in float64 on the CPU: in float64 on the card within 1e-9 (image,
   z, gradients to ij and colors), and in float32 (image and error buffer
   within 1e-4, z within 1e-3: float32 depth planes round their terms at
   pixel coordinates of hundreds; gradients within 1e-3 of their scale;
   the pixels where float32 and float64 take different sides of an edge
   are counted, bounded by 0.1 % of the frame and left out of the loss on
   both sides), at σ = 0 against the tiled kernel route (the
   pixels where the rational and the plane coverage differ counted and
   bounded), the median step; (b) the bench scene tiled with
   ``strict_edge=False``: the raster kernels in their non-strict mode
   against their plain versions, the main path against
   ``impl="reference"`` and the median step; (c) the duck with
   ``perspective_correct=True`` through ``render_scene`` on its plan: the
   raster kernels in their perspective mode (8 attribute planes) against
   their plain versions, the path (its textured edges take the sequential
   pass, windowed) against ``impl="reference"``, a 3-step median; (d)
   ``Scene3D`` on a 192-face torus (no tiling) at 640×480, σ = 1, textured
   and untextured: render + render_backward on the card in float64 against
   ``impl="reference"`` in float64 on the CPU (image, z and gradients
   within 1e-9), the float32 step's results finite and on the card, its
   median time. Launch
   counts are zeroed before and read after each path;
7. one JSON line ``{"kernels": [...]}``, one record per kernel and main path
   that launches it (launches on that path, error, times, the least time the
   card could take at that path's shapes): 22 records over the paths
   ``bench``, ``duck``, ``duck_scene3d``, ``duck_quad``, ``bench_nonstrict``
   and ``duck_persp``. ``ms`` times calls
   of the wrapper with CUDA events, host cost of the call included;
   ``device_ms`` (and ``library_device_ms``) is the device time of one call
   from ``torch.profiler``, every kernel's in one profiler session (each
   function's device events are told apart by the card's idle gaps and
   checked by what they hold: ``reps`` repeats of one sequence of
   operations, with the wrapper's kernel by name). The same session counts the
   device operations of one call of the wrappers, which must be one for the
   raster, edge and textured edge forward, the raster and edge backward and
   both quad-blend kernels (the kernel, no memset beside it) and two for the
   textured edge backward (the texture gradient's zero-fill and the kernel). A kernel's operations
   bound counts only the (pixel, slot) pairs its slots cover; each backward
   bound is printed twice: with the used rows of its table written, and
   with the whole table (the zero rows up to the capacity) written;
8. last line ``{"ok": true, "device": {...}}``.

The scenes come from ``deodr_tpu_torch.bench_scene`` (numpy, seed 0, as
``bench.py`` builds it) and ``deodr_tpu_torch.duck_scene`` (``data/duck.obj``
and its texture); nothing of JAX or of the JAX package is imported.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and float32 (non-tensor-core) rate
PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12
AA_EDGE_CAPACITY = 600
# float operations per (pixel, slot) visit of each kernel's per-slot test,
# counted from the kernel source (multiplies, adds, compares); the blend of
# the few pixels inside a band is left out, so the bound stays a lower bound.
# A kernel needs to visit only the pixels a slot covers (the raster
# coverage predicate, raster_kernel.covered_visits; an edge band's clip
# planes and y range, edge_kernel.covered_visits): the rest fail on a whole
# region at once
OPS_PER_VISIT = {"raster_fwd": 33, "edge_fwd": 33, "edge_bwd": 33, "edge_tex_fwd": 33, "edge_tex_bwd": 33}
# the raster forward's per-visit test in its non-strict mode (y and x ranges of two parts, the depth plane and
# its tests; the row's bounds are shared by a half-warp), and the division of its perspective mode
RASTER_NONSTRICT_OPS, RASTER_PERSP_OPS = 17, 1
# the main paths whose measurements each kernel's records carry: the kernels line has one record per (kernel,
# path). "duck" is render_scene on the duck's constant plan, "duck_scene3d" and "duck_quad" Scene3D on the
# duck through its own planner, without and with the quad fetch; B4 runs only on "duck_quad"
DUCK_PATHS = ("duck", "duck_scene3d", "duck_quad")
# "bench_nonstrict" and "duck_persp" run the raster kernels in their non-strict and perspective modes
MODE_PATHS = ("bench_nonstrict", "duck_persp")
KERNEL_PATHS = {"raster_fwd": ("bench",) + DUCK_PATHS + MODE_PATHS, "raster_bwd": ("bench",) + DUCK_PATHS + MODE_PATHS,
                "edge_fwd": ("bench",),
                "edge_bwd": ("bench",), "edge_tex_fwd": DUCK_PATHS, "edge_tex_bwd": DUCK_PATHS,
                "quad_blend_fwd": ("duck_quad",), "quad_blend_bwd": ("duck_quad",)}
KERNEL_SOURCES = {
    "raster_fwd": ("deodr_tpu_torch/csrc/raster_kernel.cu", "deodr_tpu/ops/pallas/raster_kernel.py:137"),
    "raster_bwd": ("deodr_tpu_torch/csrc/raster_kernel.cu", "deodr_tpu/ops/pallas/raster_kernel.py:193"),
    "edge_fwd": ("deodr_tpu_torch/csrc/edge_kernel.cu", "deodr_tpu/ops/pallas/edge_kernel.py:150"),
    "edge_bwd": ("deodr_tpu_torch/csrc/edge_kernel.cu", "deodr_tpu/ops/pallas/edge_kernel.py:202"),
    "edge_tex_fwd": ("deodr_tpu_torch/csrc/edge_tex_kernel.cu", "deodr_tpu/ops/pallas/edge_tex_kernel.py:160"),
    "edge_tex_bwd": ("deodr_tpu_torch/csrc/edge_tex_kernel.cu", "deodr_tpu/ops/pallas/edge_tex_kernel.py:257"),
    "quad_blend_fwd": ("deodr_tpu_torch/csrc/quad_blend_kernel.cu", "deodr_tpu/ops/pallas/quad_blend_kernel.py:72"),
    "quad_blend_bwd": ("deodr_tpu_torch/csrc/quad_blend_kernel.cu", "deodr_tpu/ops/pallas/quad_blend_kernel.py:90"),
}


class Failure(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise Failure(what)


def max_err(a, b) -> float:
    if a.numel() == 0:
        return 0.0
    return float((a.double() - b.double()).abs().max())


def rel_err(a, b) -> float:
    """max |a - b| over the larger of 1 and max |b| (the scale of b)."""
    return max_err(a, b) / max(float(b.double().abs().max()) if b.numel() else 0.0, 1.0)


def time_ms(fn, reps: int, device) -> float:
    """Mean time of ``fn`` over ``reps`` calls after one warm-up; CUDA
    events on the card, the host clock elsewhere (rehearsal only)."""
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_times(fns, device, reps: int = 10):
    """Device time of one call of each function of ``fns`` (key → (function,
    the name of the hand kernel it launches, or None for a PyTorch call)),
    all measured in one ``torch.profiler`` session (a session's start costs
    seconds): after a warm-up, before and inside the session (whose first
    tens of device events can go missing: inside, ``reps`` calls of each
    function), the ``reps`` calls of each function run
    in turn with 10 ms of idle card between two functions, and the device
    operations fall into one group per function (after the warm-up's, which
    a session may lose whole) where the card idles for more than 3 ms (the
    profiler's device and host clocks can drift apart by
    milliseconds, so the groups are not matched by host time). A group is
    given to its function by what it holds: ``reps`` repeats of one
    sequence of device operations, which launches the function's hand
    kernel, or none of the hand kernels (namespace ``deodr``) for a PyTorch
    call; a group that split or lost its events cannot hand its
    neighbour's time to a function unnoticed. A group's durations are
    summed. Beside ``time_ms`` it tells a kernel's own time from the host's
    cost of calling it → key → (ms, device operations) per call; (None,
    None) without a card. Raises ``Failure`` where three sessions give no
    such groups."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if device.type != "cuda" or not fns:
        return dict.fromkeys(fns, (None, None))
    for fn, _ in fns.values():
        fn()
    torch.cuda.synchronize()

    def holds(group, kernel):
        seq = [op_name for _, _, op_name in group]
        k = len(seq) // reps
        if k == 0 or len(seq) != k * reps or any(seq[i] != seq[i % k] for i in range(len(seq))):
            return False
        return any(kernel in s for s in seq[:k]) if kernel else not any("deodr" in s for s in seq[:k])

    seen = []
    for _ in range(3):  # the profiler now and then records no device events at all
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for fn, _ in fns.values():  # the warm-up group: a session can miss its first tens of device events
                for _ in range(reps):
                    fn()
            torch.cuda.synchronize()
            for fn, _ in fns.values():
                time.sleep(0.01)
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
        ops = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                     if e.device_type == DeviceType.CUDA)
        groups = []
        for op in ops:
            if not groups or op[0] - groups[-1][-1][1] > 3000:
                groups.append([])
            groups[-1].append(op)
        # the warm-up's group, unless the session lost its first device events with it
        groups = groups[len(groups) - len(fns):] if len(groups) in (len(fns), len(fns) + 1) else groups[1:]
        misplaced = [(key[1], kernel, sorted({op[2][:60] for op in g}))
                     for (key, (_, kernel)), g in zip(fns.items(), groups) if not holds(g, kernel)]
        if len(groups) == len(fns) and not misplaced:
            break
        seen.append(f"{len(groups)} groups for {len(fns)} functions after the warm-up, "
                    f"{len(misplaced)} not {reps} calls of their function (first: {misplaced[:1]})")
    else:
        raise Failure("device_times: no profiler session gave each function a group of its own kernels: "
                      + "; ".join(seen))
    return {key: (sum(end - start for start, end, _ in g) / 1e3 / reps, len(g) / reps)
            for key, g in zip(fns, groups)}


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S, n_ops / PEAK_F32_OPS_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def check_edge_bwd_repeat(bwd, bargs, outs, tag, say):
    """A second call of an edge backward wrapper gives bit-identical
    gradient rows and buffer cotangent: the kernels sum in a fixed order."""
    again = bwd(*bargs)
    check(torch.equal(again[0], outs[0]) and torch.equal(again[1], outs[1]),
          f"{tag}: two calls gave different g_rows or g_buf0")
    say(f"{tag}: two calls gave bit-identical g_rows and g_buf0")


def bench_setup(device, height=512, width=512, n_tri=200):
    """The bench scene (seed 0, as bench.py builds it), its tiling and the
    observation → (fields, scene, tiling, obs)."""
    from deodr_tpu_torch import scene_buffers_from_numpy, suggest_tiling
    from deodr_tpu_torch.bench_scene import bench_scene_fields

    fields = bench_scene_fields(height, width, n_tri)
    scene = scene_buffers_from_numpy(fields, device=device, dtype=torch.float32)
    tiling = suggest_tiling(fields["ij"], fields["faces"], height, width, sigma=1.0,
                            edgeflags=fields["edgeflags"], margin=1.0, for_pallas=True, bucket_mode="exact")
    obs = torch.from_numpy(np.random.RandomState(3).rand(height, width, 3).astype(np.float32)).to(device)
    return fields, scene, tiling, obs


def duck_setup(device):
    """The duck scene and its observation, the render on the plan constants
    of deodr_tpu_torch.duck_scene brightened by 0.05 → (fields, scene, obs)."""
    from deodr_tpu_torch import duck_scene as ds
    from deodr_tpu_torch import render_scene, scene_buffers_from_numpy

    fields = ds.duck_scene_fields()
    scene = scene_buffers_from_numpy(fields, device=device, dtype=torch.float32)
    with torch.no_grad():
        image, _, _ = render_scene(scene, ds.DUCK_SIGMA, aa_edge_capacity=ds.DUCK_AA_EDGE_CAPACITY,
                                   tiling=ds.DUCK_TILING, aa_tex_plan=ds.DUCK_TEX_PLAN)
    return fields, scene, (image + 0.05).clamp(0.0, 1.0)


def edge_inputs(scene, tiling, obs, sigma, edge_cap, tex_plan=None):
    """The edge pass's inputs as render_scene builds them, on the solid
    pass of the plain versions; with ``tex_plan``, the textured pass's split
    and compacted segments → {error_mode: (tables, buffer, z_pad, obs_pad)}
    for image and error mode."""
    from deodr_tpu_torch.ops.edge_aa import EdgeAAConfig
    from deodr_tpu_torch.ops.render import _build_edge_data, prepare
    from deodr_tpu_torch.ops.tiled import (
        compact_active_edges, edge_tables, pad_edge_buffers, rasterize_tiled_kernel, split_edges,
    )

    with torch.no_grad():
        ij_off, signed_area, draw, background = prepare(scene)
        image, z_buffer, _ = rasterize_tiled_kernel(scene, ij_off, draw, background, tiling, impl="reference")
        edges = _build_edge_data(scene, ij_off, signed_area, edge_cap)
        if tex_plan is not None:
            edges = split_edges(edges, tex_plan.n_split, None, uv_segment_length=tex_plan.uv_segment_length)
            edges = compact_active_edges(edges, tex_plan.seg_capacity)
        out = {}
        for error_mode in (False, True):
            cfg = EdgeAAConfig(scene.height, scene.width, sigma, scene.clockwise, error_mode, tex_plan is not None)
            et = edge_tables(cfg, edges, z_buffer, tiling)
            buffer = ((image - obs) ** 2).sum(dim=-1) if error_mode else image
            out[error_mode] = (et, *pad_edge_buffers(cfg, buffer, z_buffer, obs, et.grid))
    return out


def cull_line(name, module, table, counts, grid, covered, say, **mode):
    """The work of a forward kernel's region cull on this path's tables:
    the (warp region, slot) pairs it keeps (counted by the plain mirror of
    the cull, ``module.region_cull``, in the kernel's ``mode``), against
    all of them, and the (pixel, slot) pairs the slots cover."""
    rows = int(counts.to(torch.int64).clamp(max=table.shape[1]).sum())
    kept = module.region_cull(table, counts, grid, **mode)
    say(f"{name} cull: (warp region, slot) pairs kept {int(kept.sum())} of {rows * kept.shape[1]}; "
        f"covered (pixel, slot) pairs {covered} of {rows * grid.tile_h * grid.tile_w}")


def check_raster_kernels(scene, tiling, device, say, gen):
    """The raster kernels against their plain versions on ``scene``'s
    tables, in the scene's coverage (``strict_edge``) and depth
    (``perspective_correct``) modes; returns their measurements."""
    from deodr_tpu_torch.ops.kernels import raster_kernel as rk
    from deodr_tpu_torch.ops.render import prepare
    from deodr_tpu_torch.ops.tiled import raster_tables

    out = {}
    mode = dict(strict=bool(scene.strict_edge), persp=bool(scene.perspective_correct))
    ops_per_visit = ((OPS_PER_VISIT["raster_fwd"] if mode["strict"] else RASTER_NONSTRICT_OPS)
                     + (RASTER_PERSP_OPS if mode["persp"] else 0))
    with torch.no_grad():
        ij_off, _, draw, _ = prepare(scene)
        rt = raster_tables(scene, ij_off, draw, tiling)
        grid, cap_r = rt.grid, rt.setup_tile.shape[1]
        n_px = grid.tile_h * grid.tile_w
        visits = rk.covered_visits(rt.setup_tile, rt.counts, grid, **mode)
        d = rt.affine_tile.shape[2] // 3
        esz = rt.affine_tile.element_size()

        def fwd(impl="kernel"):
            return rk.raster_fwd(rt.setup_tile, rt.affine_tile, rt.counts, grid, impl, **mode)

        s_ref, z_ref, v_ref = fwd("reference")
        s_k, z_k, v_k = fwd()
        check(torch.equal(s_ref, s_k), "raster_fwd slot_map differs from the plain version")
        fin = torch.isfinite(z_ref)
        check(torch.equal(fin, torch.isfinite(z_k)), "raster_fwd coverage differs")
        e_z = max_err(z_k[fin], z_ref[fin])
        e_v = max_err(v_k, v_ref)
        say(f"raster_fwd (D = {d}, {mode}): slot_map exact, z err {e_z:.3g} (limit 1e-5), vals err {e_v:.3g} "
            "(limit 1e-4)")
        check(e_z <= 1e-5 and e_v <= 1e-4, "raster_fwd outside its tolerance")
        rows = int(rt.counts.to(torch.int64).clamp(max=cap_r).sum())
        p_total = grid.n_tiles * n_px
        cull_line("raster_fwd", rk, rt.setup_tile, rt.counts, grid, visits, say, strict=mode["strict"])
        out["raster_fwd"] = dict(
            max_abs_err=max(e_z, e_v),
            ms=time_ms(fwd, 50, device),
            device_fn=fwd,
            plain_ms=time_ms(lambda: fwd("reference"), 3, device),
            bound=bound_ms(rows * (22 + 3 * d) * esz + grid.n_tiles * 4 + p_total * (4 + esz * (1 + d)),
                           visits * ops_per_visit + p_total * 4 * d),
        )

        g_vals = torch.rand(v_ref.shape, generator=gen, dtype=v_ref.dtype).to(device)
        gt_ref = rk.raster_bwd(s_ref, g_vals, rt.counts, grid, cap_r, impl="reference")
        gt_k = rk.raster_bwd(s_ref, g_vals, rt.counts, grid, cap_r)
        e_g = rel_err(gt_k, gt_ref)
        say(f"raster_bwd (D = {d}): g_table err {e_g:.3g} of scale (limit 1e-3)")
        check(e_g <= 1e-3, "raster_bwd outside its tolerance")
        out["raster_bwd"] = dict(
            max_abs_err=max_err(gt_k, gt_ref),
            ms=time_ms(lambda: rk.raster_bwd(s_ref, g_vals, rt.counts, grid, cap_r), 50, device),
            device_fn=lambda: rk.raster_bwd(s_ref, g_vals, rt.counts, grid, cap_r),
            plain_ms=time_ms(lambda: rk.raster_bwd(s_ref, g_vals, rt.counts, grid, cap_r, impl="reference"), 3, device),
            bound=bound_ms(p_total * (4 + esz * d) + rows * 3 * d * esz, p_total * 6 * d),
        )
        # the kept bound writes the used rows only; the kernel also writes the zero rows up to cap
        full = bound_ms(p_total * (4 + esz * d) + grid.n_tiles * cap_r * 3 * d * esz, p_total * 6 * d)[0]
        say(f"raster_bwd bound {out['raster_bwd']['bound'][0]:.5f} ms with the {rows} used rows written, "
            f"{full:.5f} ms with all {grid.n_tiles} x {cap_r} rows written")
    return out


def check_kernels(scene, tiling, obs, device, say):
    """Each kernel of the untextured path against its plain version at the
    bench scene's shapes; returns per-kernel measurements."""
    from deodr_tpu_torch.ops.kernels import edge_kernel as ek

    gen = torch.Generator(device="cpu").manual_seed(1)
    out = check_raster_kernels(scene, tiling, device, say, gen)
    with torch.no_grad():
        esz = scene.ij.element_size()
        inputs = edge_inputs(scene, tiling, obs, 1.0, AA_EDGE_CAPACITY)
        for name in ("edge_fwd", "edge_bwd"):
            out[name] = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound=(0.0, "operations"))
        for error_mode in (False, True):
            mode = "error" if error_mode else "image"
            et, buf, z_pad, obs_pad = inputs[error_mode]
            args = (et.table_tile, buf, z_pad, obs_pad, et.counts, et.grid, error_mode)
            o_ref = ek.edge_fwd(*args, impl="reference")
            o_k = ek.edge_fwd(*args)
            e_o = max_err(o_k, o_ref)
            say(f"edge_fwd ({mode}): out err {e_o:.3g} (limit 1e-4)")
            check(e_o <= 1e-4, f"edge_fwd ({mode}) outside its tolerance")

            g_out = torch.rand(o_ref.shape, generator=gen, dtype=o_ref.dtype).to(device)
            bargs = (et.table_tile, o_ref, z_pad, obs_pad, g_out, et.counts, et.grid, error_mode)
            gr_ref, gb_ref = ek.edge_bwd(*bargs, impl="reference")
            gr_k, gb_k = ek.edge_bwd(*bargs)
            e_r, e_b = rel_err(gr_k, gr_ref), max_err(gb_k, gb_ref)
            say(f"edge_bwd ({mode}): g_table err {e_r:.3g} of scale (limit 1e-3), g_buf0 err {e_b:.3g} (limit 1e-4)")
            check(e_r <= 1e-3 and e_b <= 1e-4, f"edge_bwd ({mode}) outside its tolerance")
            check_edge_bwd_repeat(ek.edge_bwd, bargs, (gr_k, gb_k), f"edge_bwd ({mode})", say)
            out["edge_fwd"]["max_abs_err"] = max(out["edge_fwd"]["max_abs_err"], e_o)
            out["edge_bwd"]["max_abs_err"] = max(out["edge_bwd"]["max_abs_err"], max_err(gr_k, gr_ref), e_b)
            if not error_mode:  # times and bounds in image mode, the bench's mode
                e_cap = et.table_tile.shape[1]
                e_rows = int(et.counts.to(torch.int64).clamp(max=e_cap).sum())
                e_visits = ek.covered_visits(et.table_tile, et.counts, et.grid)
                w_row, c = et.table_tile.shape[2], buf.shape[0]
                p_e = et.grid.n_tiles * et.grid.tile_h * et.grid.tile_w
                say(f"edge tables: {et.grid.n_tiles} tiles of {et.grid.tile_h}x{et.grid.tile_w}, {e_rows} slots in "
                    f"use; the band-clip planes and y range hold at {e_visits} of the "
                    f"{e_rows * et.grid.tile_h * et.grid.tile_w} (pixel, slot) pairs (the operations bound's visits)")
                cull_line("edge_fwd", ek, et.table_tile, et.counts, et.grid, e_visits, say)
                out["edge_fwd"].update(
                    ms=time_ms(lambda: ek.edge_fwd(*args), 50, device),
                    device_fn=lambda args=args: ek.edge_fwd(*args),
                    plain_ms=time_ms(lambda: ek.edge_fwd(*args, impl="reference"), 3, device),
                    bound=bound_ms(e_rows * w_row * esz + p_e * esz * (2 * c + 1),
                                   e_visits * OPS_PER_VISIT["edge_fwd"]),
                )
                out["edge_bwd"].update(
                    ms=time_ms(lambda: ek.edge_bwd(*bargs), 20, device),
                    device_fn=lambda bargs=bargs: ek.edge_bwd(*bargs),
                    plain_ms=time_ms(lambda: ek.edge_bwd(*bargs, impl="reference"), 3, device),
                    bound=bound_ms(e_rows * (w_row + 3 + 3 * c) * esz + p_e * esz * (3 * c + 1),
                                   e_visits * OPS_PER_VISIT["edge_bwd"]),
                )
                # the kept bound writes the used rows only; the kernel also writes the zero rows up to cap
                full = bound_ms(e_rows * w_row * esz + et.grid.n_tiles * e_cap * (3 + 3 * c) * esz
                                + p_e * esz * (3 * c + 1), e_visits * OPS_PER_VISIT["edge_bwd"])[0]
                say(f"edge_bwd bound {out['edge_bwd']['bound'][0]:.5f} ms with the {e_rows} used rows written, "
                    f"{full:.5f} ms with all {et.grid.n_tiles} x {e_cap} rows written")
    return out


def loss_and_grads(scene, sigma, tiling, obs, error_mode, impl, check_capacity=True, with_z=False, weight=None,
                   **kwargs):
    """(out, loss, d loss/d ij, d loss/d colors[, z-buffer]) of the bench
    loss, each pixel's term times ``weight`` (H, W) where given; ``kwargs``
    go to render_scene."""
    from deodr_tpu_torch import render_scene

    ij = scene.ij.detach().clone().requires_grad_(True)
    colors = scene.colors.detach().clone().requires_grad_(True)
    s = dataclasses.replace(scene, ij=ij, colors=colors)
    image, z_buffer, err = render_scene(
        s, sigma, antialiase_error=error_mode, obs=obs, aa_edge_capacity=AA_EDGE_CAPACITY, tiling=tiling,
        impl=impl, check_capacity=check_capacity, **kwargs,
    )
    out = err if error_mode else image
    per_pixel = out if error_mode else ((image - obs) ** 2).sum(dim=-1)
    loss = (per_pixel if weight is None else per_pixel * weight).sum()
    loss.backward()
    return (out.detach(), loss.detach(), ij.grad, colors.grad) + ((z_buffer,) if with_z else ())


def main_path(scene, tiling, obs, say, name="main path"):
    """Phase 3: the main path on the kernels against impl='reference'."""
    for sigma in (0.0, 1.0):
        for error_mode in (False, True):
            tag = f"{name} sigma={sigma:g} {'error' if error_mode else 'image'} mode"
            o_k, l_k, gij_k, gc_k = loss_and_grads(scene, sigma, tiling, obs, error_mode, "kernel")
            o_r, l_r, gij_r, gc_r = loss_and_grads(scene, sigma, tiling, obs, error_mode, "reference")
            check(all(bool(torch.isfinite(g).all()) for g in (gij_k, gc_k)), f"{tag}: non-finite gradients")
            e_o, e_ij, e_c = max_err(o_k, o_r), rel_err(gij_k, gij_r), rel_err(gc_k, gc_r)
            say(f"{tag}: loss {float(l_k):.6f} vs {float(l_r):.6f}, out err {e_o:.3g} (limit 1e-4), "
                f"grad ij err {e_ij:.3g}, grad colors err {e_c:.3g} of scale (limit 1e-3)")
            check(e_o <= 1e-4 and e_ij <= 1e-3 and e_c <= 1e-3, f"{tag}: kernels disagree with the plain versions")


def train(scene, tiling, device, say, steps=20):
    """Phase 5: descent on (ij, colors) from a seeded perturbation towards
    the unperturbed render at σ = 1; returns the losses."""
    from deodr_tpu_torch import render_scene

    with torch.no_grad():
        target, _, _ = render_scene(scene, 1.0, aa_edge_capacity=AA_EDGE_CAPACITY, tiling=tiling)
    rng = np.random.RandomState(2)
    offset = torch.from_numpy(rng.uniform(-1.5, 1.5, tuple(scene.ij.shape)).astype(np.float32)).to(device)
    ij = (scene.ij + offset).to(scene.ij.dtype).requires_grad_(True)
    colors = scene.colors.detach().clone().requires_grad_(True)
    losses, lr_ij, lr_c = [], None, None
    for _ in range(steps):
        s = dataclasses.replace(scene, ij=ij, colors=colors)
        image, _, _ = render_scene(s, 1.0, aa_edge_capacity=AA_EDGE_CAPACITY, tiling=tiling, check_capacity=True)
        loss = ((image - target) ** 2).sum()
        g_ij, g_c = torch.autograd.grad(loss, (ij, colors))
        if lr_ij is None:  # steps of at most 0.2 px and 0.01 in color at the start
            lr_ij = 0.2 / max(float(g_ij.abs().max()), 1e-12)
            lr_c = 0.01 / max(float(g_c.abs().max()), 1e-12)
        with torch.no_grad():
            ij -= lr_ij * g_ij
            colors -= lr_c * g_c
        losses.append(float(loss.detach()))
    say("trainer losses: " + " ".join(f"{v:.3f}" for v in losses))
    check(all(np.isfinite(losses)) and losses[-1] < losses[0], "the descent did not lower the loss")
    return losses


def median_step_ms(step, device, reps=20):
    """Median ms of ``step()`` over ``reps`` calls after three warm-ups:
    CUDA events on the card, the host clock elsewhere (rehearsal only)."""
    for _ in range(3):
        step()
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            step()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            step()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def step_times(scene, tiling, obs, device):
    """Median ms of one fwd+bwd step (render, loss, backward) per σ."""
    return {
        sigma: median_step_ms(
            lambda: loss_and_grads(scene, sigma, tiling, obs, False, "kernel", check_capacity=False), device
        )
        for sigma in (0.0, 1.0)
    }


def profile_step(step, tag, device, say, steps=5):
    """Where one fwd+bwd ``step()`` spends its time: host wall clock per
    step (profiler on), device busy time (sum of the card's kernel and copy
    durations, one stream) and the number of device operations per step,
    and the device time of the heaviest operations by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if device.type != "cuda":
        say(f"profile {tag}: not measured (no card)")
        return
    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    device_ops = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not device_ops:
        say(f"profile {tag}: wall {wall_ms:.4f} ms/step; device time not measured (the profiler saw no device ops)")
        return
    by_name = {}
    for e in device_ops:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / steps
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    say(f"profile {tag}: wall {wall_ms:.4f} ms/step (profiler on), device busy {busy:.4f} ms/step "
        f"({100 * busy / wall_ms:.2f}% of wall), {len(device_ops) / steps:.0f} device ops/step")
    say(f"profile {tag} top device time (ms/step): " + "; ".join(f"{name[:60]} {ms:.4f}" for name, ms in top))


# ------------------------------------------------------ the duck (textured)


def check_tex_kernels(scene, obs, device, say, plan=None):
    """The textured edge kernel against its plain version at the duck's
    shapes, image and error mode, and the raster kernels again with the
    textured scene's 7 attribute planes; returns per-kernel measurements.
    ``plan`` = (aa_edge_capacity, tiling, aa_tex_plan), by default the
    constants of ``deodr_tpu_torch.duck_scene``."""
    from deodr_tpu_torch import duck_scene as ds
    from deodr_tpu_torch.ops.kernels import edge_kernel as ek
    from deodr_tpu_torch.ops.kernels import edge_tex_kernel as etk

    gen = torch.Generator(device="cpu").manual_seed(4)
    edge_cap, tiling, plan = plan or (ds.DUCK_AA_EDGE_CAPACITY, ds.DUCK_TILING, ds.DUCK_TEX_PLAN)
    out = check_raster_kernels(scene, tiling, device, say, gen)
    texture = scene.texture
    with torch.no_grad():
        esz = scene.ij.element_size()
        inputs = edge_inputs(scene, tiling, obs, ds.DUCK_SIGMA, edge_cap, plan)
        for name in ("edge_tex_fwd", "edge_tex_bwd"):
            out[name] = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound=(0.0, "operations"))
        for error_mode in (False, True):
            mode = "error" if error_mode else "image"
            et, buf, z_pad, obs_pad = inputs[error_mode]
            args = (et.table_tile, texture, buf, z_pad, obs_pad, et.counts, et.grid, error_mode)
            o_ref = etk.edge_tex_fwd(*args, impl="reference")
            o_k = etk.edge_tex_fwd(*args)
            e_o = max_err(o_k, o_ref)
            changed = int((o_ref != buf).any(dim=0).sum())
            say(f"edge_tex_fwd ({mode}): out err {e_o:.3g} (limit 1e-4); the bands blend {changed} pixels")
            check(e_o <= 1e-4 and changed > 0, f"edge_tex_fwd ({mode}) outside its tolerance")

            g_out = torch.rand(o_ref.shape, generator=gen, dtype=o_ref.dtype).to(device)
            bargs = (et.table_tile, texture, o_ref, z_pad, obs_pad, g_out, et.counts, et.grid, error_mode)
            gr_ref, gb_ref, gt_ref = etk.edge_tex_bwd(*bargs, impl="reference")
            gr_k, gb_k, gt_k = etk.edge_tex_bwd(*bargs)
            e_r, e_b, e_t = rel_err(gr_k, gr_ref), max_err(gb_k, gb_ref), rel_err(gt_k, gt_ref)
            say(f"edge_tex_bwd ({mode}): g_table err {e_r:.3g} of scale (limit 1e-3), g_buf0 err {e_b:.3g} "
                f"(limit 1e-4), g_texture err {e_t:.3g} of scale (limit 1e-3; atomics sum in another order)")
            check(e_r <= 1e-3 and e_b <= 1e-4 and e_t <= 1e-3, f"edge_tex_bwd ({mode}) outside its tolerance")
            check(float(gt_k.abs().max()) > 0 and float(gr_k[..., -9:].abs().max()) > 0,
                  f"edge_tex_bwd ({mode}): no gradient reached the texture or the uv/shade rows")
            check_edge_bwd_repeat(etk.edge_tex_bwd, bargs, (gr_k, gb_k), f"edge_tex_bwd ({mode})", say)
            out["edge_tex_fwd"]["max_abs_err"] = max(out["edge_tex_fwd"]["max_abs_err"], e_o)
            out["edge_tex_bwd"]["max_abs_err"] = max(
                out["edge_tex_bwd"]["max_abs_err"], max_err(gr_k, gr_ref), e_b, max_err(gt_k, gt_ref)
            )
            if not error_mode:  # times and bounds in image mode, the duck loss's mode
                e_cap = et.table_tile.shape[1]
                e_rows = int(et.counts.to(torch.int64).clamp(max=e_cap).sum())
                e_visits = ek.covered_visits(et.table_tile, et.counts, et.grid)
                w_row, c = et.table_tile.shape[2], buf.shape[0]
                p_e = et.grid.n_tiles * et.grid.tile_h * et.grid.tile_w
                # texels: 4 taps x C only where a textured slot paints (counted from this run's tables);
                # the backward reads them, adds as many with atomics, and writes the dense texture gradient
                tex_visits = etk.textured_visits(et.table_tile, z_pad, et.counts, et.grid)
                tap_bytes = tex_visits * 4 * c * esz
                say(f"edge_tex tables: {et.grid.n_tiles} tiles of {et.grid.tile_h}x{et.grid.tile_w}, {e_rows} slots "
                    f"in use (capacity {e_cap}, fullest tile {int(et.counts.max())}), row width {w_row}; the band-clip "
                    f"planes and y range hold at {e_visits} of the {e_rows * et.grid.tile_h * et.grid.tile_w} (pixel, "
                    f"slot) pairs (the operations bound's visits); textured slots paint {tex_visits} pairs, "
                    f"{tap_bytes} bytes of taps")
                cull_line("edge_tex_fwd", etk, et.table_tile, et.counts, et.grid, e_visits, say)
                out["edge_tex_fwd"].update(
                    ms=time_ms(lambda: etk.edge_tex_fwd(*args), 50, device),
                    device_fn=lambda args=args: etk.edge_tex_fwd(*args),
                    plain_ms=time_ms(lambda: etk.edge_tex_fwd(*args, impl="reference"), 3, device),
                    bound=bound_ms(e_rows * w_row * esz + p_e * esz * (2 * c + 1) + tap_bytes,
                                   e_visits * OPS_PER_VISIT["edge_tex_fwd"]),
                )
                out["edge_tex_bwd"].update(
                    ms=time_ms(lambda: etk.edge_tex_bwd(*bargs), 20, device),
                    device_fn=lambda bargs=bargs: etk.edge_tex_bwd(*bargs),
                    plain_ms=time_ms(lambda: etk.edge_tex_bwd(*bargs, impl="reference"), 3, device),
                    bound=bound_ms(e_rows * (w_row + 12 + 3 * c) * esz + p_e * esz * (3 * c + 1) + 2 * tap_bytes
                                   + texture.numel() * esz,
                                   e_visits * OPS_PER_VISIT["edge_tex_bwd"]),
                )
                full = bound_ms(e_rows * w_row * esz + et.grid.n_tiles * e_cap * (12 + 3 * c) * esz
                                + p_e * esz * (3 * c + 1) + 2 * tap_bytes + texture.numel() * esz,
                                e_visits * OPS_PER_VISIT["edge_tex_bwd"])[0]
                say(f"edge_tex_bwd bound {out['edge_tex_bwd']['bound'][0]:.5f} ms with the {e_rows} used rows "
                    f"written, {full:.5f} ms with all {et.grid.n_tiles} x {e_cap} rows written")
    return out


DUCK_PARAMS = ("ij", "uv", "shade", "texture")


def duck_loss_and_grads(scene, obs, impl, check_capacity=False, **kwargs):
    """The duck loss Σ (render − obs)² with its gradients to ij, uv, shade
    and texture → (image, z-buffer, loss, gradients by name); ``kwargs``
    go to render_scene."""
    from deodr_tpu_torch import duck_scene as ds
    from deodr_tpu_torch import render_scene

    leaves = {k: getattr(scene, k).detach().clone().requires_grad_(True) for k in DUCK_PARAMS}
    image, z_buffer, _ = render_scene(
        dataclasses.replace(scene, **leaves), ds.DUCK_SIGMA, aa_edge_capacity=ds.DUCK_AA_EDGE_CAPACITY,
        tiling=ds.DUCK_TILING, aa_tex_plan=ds.DUCK_TEX_PLAN, impl=impl, check_capacity=check_capacity, **kwargs,
    )
    loss = ((image - obs) ** 2).sum()
    grads = torch.autograd.grad(loss, [leaves[k] for k in DUCK_PARAMS])
    return image.detach(), z_buffer, loss.detach(), dict(zip(DUCK_PARAMS, grads))


def duck_main_path(scene, obs, say, **kwargs):
    """The duck's fwd+bwd on the kernels against impl='reference', every
    capacity of the plan checked."""
    img_k, z_k, l_k, g_k = duck_loss_and_grads(scene, obs, "kernel", check_capacity=True, **kwargs)
    img_r, z_r, l_r, g_r = duck_loss_and_grads(scene, obs, "reference", check_capacity=True, **kwargs)
    fin = torch.isfinite(z_r)
    check(torch.equal(fin, torch.isfinite(z_k)), "duck: coverage differs from the plain versions")
    check(tuple(img_k.shape) == (scene.height, scene.width, 3) and bool(torch.isfinite(img_k).all()),
          "duck: the image is not finite or has the wrong shape")
    e_img, e_z = max_err(img_k, img_r), max_err(z_k[fin], z_r[fin])
    errs = {k: rel_err(g_k[k], g_r[k]) for k in DUCK_PARAMS}
    say(f"duck main path: loss {float(l_k):.4f} vs {float(l_r):.4f}, image err {e_img:.3g} (limit 1e-4), "
        f"z err {e_z:.3g} (limit 1e-5), covered pixels {int(fin.sum())}; gradient err of scale (limit 1e-3): "
        + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()))
    check(all(bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0 for g in g_k.values()),
          "duck: a gradient is non-finite or all zero")
    check(e_img <= 1e-4 and e_z <= 1e-5 and all(v <= 1e-3 for v in errs.values()),
          "duck: kernels disagree with the plain versions")


def duck_train(scene, obs, say, steps=6):
    """A few descent steps on the duck loss over (ij, uv, shade, texture),
    each parameter with a step normalised by its first gradient."""
    params = {k: getattr(scene, k).detach().clone() for k in DUCK_PARAMS}
    first_step = {"ij": 0.05, "uv": 0.05, "shade": 0.01, "texture": 0.01}  # largest move of the first step
    rates, losses = {}, []
    for _ in range(steps):
        _, _, loss, grads = duck_loss_and_grads(dataclasses.replace(scene, **params), obs, "kernel")
        for k in DUCK_PARAMS:
            if k not in rates:
                rates[k] = first_step[k] / max(float(grads[k].abs().max()), 1e-12)
            params[k] = params[k] - rates[k] * grads[k]
        losses.append(float(loss))
    say("duck descent losses: " + " ".join(f"{v:.3f}" for v in losses))
    check(all(np.isfinite(losses)) and losses[-1] < losses[0], "the duck descent did not lower the loss")
    return losses


def run_duck(device, say):
    """Phase 4; returns (per-kernel measurements, launches on the duck's
    main path, median step ms)."""
    from deodr_tpu_torch import duck_scene as ds
    from deodr_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    fields, scene, obs = duck_setup(device)
    height, width = fields["height"], fields["width"]
    say(f"duck scene: {fields['faces'].shape[0]} faces, {fields['ij'].shape[0]} vertices, {fields['uv'].shape[0]} uv "
        f"vertices, texture {tuple(fields['texture'].shape)}, {width}x{height}, {int(fields['edgeflags'].sum())} "
        f"silhouette edges, built in {time.perf_counter() - t0:.1f} s")
    say(f"duck plan: aa_edge_capacity={ds.DUCK_AA_EDGE_CAPACITY}, {ds.DUCK_TILING}, {ds.DUCK_TEX_PLAN}")

    measured = check_tex_kernels(scene, obs, device, say)

    kernels.reset_launches()
    duck_main_path(scene, obs, say)
    launches = dict(kernels.LAUNCHES)
    say(f"launches on the duck's main path: {launches}")
    for name in ("raster_fwd", "raster_bwd", "edge_tex_fwd", "edge_tex_bwd"):
        check(device.type != "cuda" or launches[name] > 0, f"{name} was never launched on the duck's main path")

    duck_train(scene, obs, say)

    def step():
        duck_loss_and_grads(scene, obs, "kernel")

    ms = median_step_ms(step, device)
    say(f"duck fwd+bwd step sigma={ds.DUCK_SIGMA:g}: median {ms:.4f} ms, {height * width / (ms * 1e-3) / 1e6:.2f} Mpix/s")
    profile_step(step, "duck", device, say)
    return measured, launches, ms


# -------------------------------------------------- Scene3D on the duck


SCENE3D_GRADS = ("vertices", "light_directional", "light_ambient", "uv", "texture")


def duck_scene3d(device, quad_fetch, impl="kernel"):
    """(Scene3D, camera) of the duck as ``bench.measure_duck`` builds it:
    the mesh's float32 tensors on the card, light and background of
    ``deodr_tpu_torch.duck_scene``."""
    from deodr_tpu_torch import duck_scene as ds
    from deodr_tpu_torch.camera import default_camera
    from deodr_tpu_torch.geometry.mesh import ColoredTriMesh
    from deodr_tpu_torch.scene import Scene3D

    mesh = ColoredTriMesh.load(str(ds.DATA_PATH / "duck.obj"))
    camera = default_camera(ds.DUCK_WIDTH, ds.DUCK_HEIGHT, 60, mesh.vertices.numpy(), np.diag([1.0, -1.0, -1.0]))
    mesh.set_vertices(mesh.vertices.to(device, torch.float32))
    mesh.uv = mesh.uv.to(device, torch.float32)
    mesh.texture = mesh.texture.to(device, torch.float32)
    scene = Scene3D(sigma=ds.DUCK_SIGMA, device=device, impl=impl, quad_fetch=quad_fetch)
    scene.set_mesh(mesh)
    scene.set_light(np.array(ds.LIGHT_DIRECTIONAL), ds.LIGHT_AMBIENT)
    scene.set_background_color(np.array(ds.BACKGROUND_COLOR))
    return scene, camera


def scene3d_step(scene, camera, obs, check_capacity=False):
    """render + render_backward of the duck loss Σ (image − obs)² →
    (image, z-buffer, gradients by name)."""
    image, z_buffer = scene.render(camera, return_z_buffer=True, check_capacity=check_capacity)
    scene.render_backward(2 * (image - obs))
    mesh = scene.mesh
    grads = dict(vertices=mesh._vertices_b, light_directional=scene.light_directional_b,
                 light_ambient=scene.light_ambient_b, uv=mesh.uv_b, texture=mesh.texture_b)
    return image, z_buffer, grads


def capture_quad_blend_inputs(scene, camera):
    """The arguments the quad fetch hands kernel B4 on this view (one
    render with the plain versions, not counted)."""
    from deodr_tpu_torch.ops.kernels import quad_blend_kernel as qbk

    seen = []
    original = qbk.quad_blend

    def recording(win, dv, du, ev, eu, impl="kernel"):
        seen.append(tuple(t.detach().contiguous() for t in (win, dv, du, ev, eu)))
        return original(win, dv, du, ev, eu, "reference")

    qbk.quad_blend = recording
    try:
        with torch.no_grad():
            scene.render(camera)
    finally:
        qbk.quad_blend = original
    check(len(seen) == 1, "the quad fetch did not reach the blend exactly once")
    return seen[0]


def check_quad_kernels(inputs, device, say, gen):
    """Kernel B4 forward and backward against their plain versions at the
    duck's quads, and grid_sample as the yardstick; returns their
    measurements."""
    import torch.nn.functional as F

    from deodr_tpu_torch.ops.kernels import quad_blend_kernel as qbk

    win, dv, du, ev, eu = inputs
    q, c = win.shape[0], win.shape[1] // 64
    esz = win.element_size()
    out_ref = qbk.quad_blend_fwd(*inputs, impl="reference")
    out_k = qbk.quad_blend_fwd(*inputs)
    e_f = max_err(out_k, out_ref)
    ct = torch.rand(out_ref.shape, generator=gen, dtype=out_ref.dtype).to(device)
    g_ref = qbk.quad_blend_bwd(*inputs, ct, impl="reference")
    g_k = qbk.quad_blend_bwd(*inputs, ct)
    e_w, e_v, e_u = (rel_err(a, b) for a, b in zip(g_k, g_ref))
    say(f"quad_blend_fwd ({q} quads, C = {c}): out err {e_f:.3g} (limit 1e-6); quad_blend_bwd: d_win err {e_w:.3g}, "
        f"d_ev err {e_v:.3g}, d_eu err {e_u:.3g} of scale (limit 1e-5)")
    check(e_f <= 1e-6 and max(e_w, e_v, e_u) <= 1e-5, "quad_blend outside its tolerance")
    check(float(g_k[0].abs().max()) > 0 and float(g_k[1].abs().max()) > 0, "quad_blend_bwd: all-zero gradients")

    # the yardstick: the windows as a (Q, C, 8, 8) batch sampled at (du + eu, dv + ev), corners aligned
    windows = win.reshape(q, 8, 8, c).permute(0, 3, 1, 2).contiguous()
    grid = torch.stack([(du + eu) * (2.0 / 7.0) - 1.0, (dv + ev) * (2.0 / 7.0) - 1.0], dim=-1)[:, None]  # (Q, 1, 4, 2)

    def library_fwd():
        return F.grid_sample(windows, grid, mode="bilinear", padding_mode="zeros", align_corners=True)

    lib = library_fwd()[:, :, 0].permute(0, 2, 1)  # (Q, 4, C)
    e_lib = max_err(lib, out_ref)
    say(f"grid_sample against quad_blend's plain version: err {e_lib:.3g} (limit 1e-5)")
    check(e_lib <= 1e-5, "grid_sample does not compute quad_blend's function")
    w_leaf, g_leaf = windows.clone().requires_grad_(True), grid.clone().requires_grad_(True)
    ct_lib = ct.permute(0, 2, 1)[:, :, None].contiguous()

    def library_fwd_bwd():
        out = F.grid_sample(w_leaf, g_leaf, mode="bilinear", padding_mode="zeros", align_corners=True)
        return torch.autograd.grad(out, (w_leaf, g_leaf), ct_lib)

    # bytes the function needs: the distinct window texels the taps read, the
    # coefficients, and the output (backward: the cotangent, and the dense
    # window cotangent and the weight cotangents it writes)
    pos = ((dv.long() * 8 + du.long())[..., None] + torch.tensor([0, 1, 8, 9], device=device)).reshape(q, 16)
    touched = torch.zeros((q, 64), dtype=torch.bool, device=device).scatter_(1, pos, True)
    tap_bytes = int(touched.sum()) * c * esz
    coef_bytes = q * 4 * (4 + 4 + 2 * esz)
    px_bytes = q * 4 * c * esz
    say(f"quad_blend: {int(touched.sum())} distinct window texels read ({tap_bytes} bytes), coefficients "
        f"{coef_bytes} bytes, samples {px_bytes} bytes, dense window cotangent {win.numel() * esz} bytes")
    lib_fwd_ms = time_ms(library_fwd, 50, device)
    lib_bwd_ms = time_ms(library_fwd_bwd, 20, device)
    say(f"grid_sample: forward {lib_fwd_ms:.4f} ms, forward + backward {lib_bwd_ms:.4f} ms")
    return {
        "quad_blend_fwd": dict(
            max_abs_err=e_f,
            ms=time_ms(lambda: qbk.quad_blend_fwd(*inputs), 50, device),
            device_fn=lambda: qbk.quad_blend_fwd(*inputs),
            plain_ms=time_ms(lambda: qbk.quad_blend_fwd(*inputs, impl="reference"), 10, device),
            bound=bound_ms(tap_bytes + coef_bytes + px_bytes, q * 4 * c * 12),
            library_ms=lib_fwd_ms,
            # the yardsticks' device times: (function, None: no hand kernel)
            library_device_fn=(library_fwd, None),
        ),
        "quad_blend_bwd": dict(
            max_abs_err=max(max_err(a, b) for a, b in zip(g_k, g_ref)),
            ms=time_ms(lambda: qbk.quad_blend_bwd(*inputs, ct), 50, device),
            device_fn=lambda: qbk.quad_blend_bwd(*inputs, ct),
            plain_ms=time_ms(lambda: qbk.quad_blend_bwd(*inputs, ct, impl="reference"), 10, device),
            bound=bound_ms(tap_bytes + coef_bytes + px_bytes + win.numel() * esz + q * 4 * 2 * esz,
                           q * 4 * c * 24),
            # the library's backward needs its forward: forward + backward less the forward
            library_ms=max(lib_bwd_ms - lib_fwd_ms, 0.0),
            library_device_fn=(library_fwd_bwd, None),
            library_device_less_fn=(library_fwd, None),
        ),
    }


def run_scene3d(device, say):
    """Phase 5; returns (measurements per path and kernel, launches per
    path, median step ms with and without the quad fetch)."""
    from deodr_tpu_torch import duck_scene as ds
    from deodr_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    scene, camera = duck_scene3d(device, quad_fetch=False)
    cap, tiling, aa_window, aa_tex_window, tex_plan = scene._eager_plan(camera)
    say(f"Scene3D duck plan (quad_fetch=False) in {time.perf_counter() - t0:.2f} s: aa_edge_capacity={cap}, {tiling}, "
        f"{tex_plan}, aa_window={aa_window}, aa_tex_window={aa_tex_window}")
    check(cap == ds.DUCK_AA_EDGE_CAPACITY, "Scene3D plan: aa_edge_capacity differs from the duck's constant")
    for name in tiling._fields:
        check(getattr(tiling, name) == getattr(ds.DUCK_TILING, name), f"Scene3D plan: {name} differs from DUCK_TILING")
    check(tex_plan == ds.DUCK_TEX_PLAN, "Scene3D plan: the textured edge plan differs from DUCK_TEX_PLAN")
    with torch.no_grad():
        obs = (scene.render(camera) + 0.05).clamp(0.0, 1.0)
        # the buffers this view hands render_scene: float32, projected on the card
        buffers, _ = scene._build_buffers(camera, *scene._diff_inputs(False), True)
    say("Scene3D duck: the raster and textured edge kernels on the tables of its own buffers")
    measured = {"duck_scene3d": check_tex_kernels(buffers, obs, device, say, plan=(cap, tiling, tex_plan))}
    reference, _ = duck_scene3d(device, quad_fetch=False, impl="reference")
    launches = {}

    kernels.reset_launches()
    img_k, z_k, g_k = scene3d_step(scene, camera, obs, check_capacity=True)
    launches["duck_scene3d"] = dict(kernels.LAUNCHES)
    img_r, z_r, g_r = scene3d_step(reference, camera, obs, check_capacity=True)
    fin = torch.isfinite(z_r)
    check(torch.equal(fin, torch.isfinite(z_k)), "Scene3D: coverage differs from the plain versions")
    e_img, e_z = max_err(img_k, img_r), max_err(z_k[fin], z_r[fin])
    errs = {k: rel_err(g_k[k], g_r[k]) for k in SCENE3D_GRADS}
    say(f"Scene3D duck (per-pixel fetch): image err {e_img:.3g} (limit 1e-4), z err {e_z:.3g} (limit 1e-5), covered "
        f"pixels {int(fin.sum())}; gradient err of scale (limit 1e-3): " + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()))
    check(tuple(img_k.shape) == (ds.DUCK_HEIGHT, ds.DUCK_WIDTH, 3) and bool(torch.isfinite(img_k).all()),
          "Scene3D: the image is not finite or has the wrong shape")
    check(all(bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0 for g in g_k.values()),
          "Scene3D: a gradient is non-finite or all zero")
    check(e_img <= 1e-4 and e_z <= 1e-5 and all(v <= 1e-3 for v in errs.values()),
          "Scene3D: kernels disagree with the plain versions")
    say(f"launches on the Scene3D per-pixel path: {launches['duck_scene3d']}")
    for name in ("raster_fwd", "raster_bwd", "edge_tex_fwd", "edge_tex_bwd"):
        check(device.type != "cuda" or launches["duck_scene3d"][name] > 0,
              f"{name} was never launched on the Scene3D per-pixel path")

    quad, _ = duck_scene3d(device, quad_fetch=True)
    q_plan = quad._eager_plan(camera)
    say(f"Scene3D duck plan (quad_fetch=True): {q_plan[1]}")
    check(q_plan[1] == ds.DUCK_TILING._replace(quad_fallback_capacity=1536) and q_plan[4] == ds.DUCK_TEX_PLAN,
          "Scene3D plan with quad_fetch=True: not the duck's plan with quad_fallback_capacity=1536")
    # the quad fetch changes only the solid pass's texture fetch: the raster and textured edge kernels
    # get the buffers, and so the tables, of the per-pixel path, and their records are that path's
    with torch.no_grad():
        q_buffers, _ = quad._build_buffers(camera, *quad._diff_inputs(False), True)
    check(all(torch.equal(getattr(q_buffers, f.name), getattr(buffers, f.name))
              for f in dataclasses.fields(buffers) if isinstance(getattr(buffers, f.name), torch.Tensor)),
          "Scene3D: the quad path's buffers differ from the per-pixel path's")
    inputs = capture_quad_blend_inputs(quad, camera)
    quad_measured = check_quad_kernels(inputs, device, say, torch.Generator(device="cpu").manual_seed(5))
    measured["duck_quad"] = dict(measured["duck_scene3d"], **quad_measured)

    kernels.reset_launches()
    img_q, z_q, g_q = scene3d_step(quad, camera, obs, check_capacity=True)
    launches["duck_quad"] = dict(kernels.LAUNCHES)
    say(f"launches on the Scene3D quad path: {launches['duck_quad']}")
    for name in ("raster_fwd", "raster_bwd", "edge_tex_fwd", "edge_tex_bwd", "quad_blend_fwd", "quad_blend_bwd"):
        check(device.type != "cuda" or launches["duck_quad"][name] > 0,
              f"{name} was never launched on the Scene3D quad path")
    e_img = max_err(img_q, img_k)
    errs = {k: rel_err(g_q[k], g_k[k]) for k in SCENE3D_GRADS}
    say(f"Scene3D duck, quad fetch against per-pixel fetch: image err {e_img:.3g} (limit 1e-5); gradient err of scale "
        "(limit 1e-3): " + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()))
    check(torch.equal(torch.isfinite(z_q), fin) and e_img <= 1e-5 and all(v <= 1e-3 for v in errs.values()),
          "Scene3D: the quad fetch disagrees with the per-pixel fetch")

    ms = {}
    for tag, s in (("per-pixel", scene), ("quad", quad)):
        ms[tag] = median_step_ms(lambda s=s: scene3d_step(s, camera, obs), device)
        say(f"Scene3D duck step ({tag} fetch, render + render_backward): median {ms[tag]:.4f} ms")
    profile_step(lambda: scene3d_step(quad, camera, obs), "Scene3D duck quad", device, say)
    profile_step(lambda: scene3d_step(scene, camera, obs), "Scene3D duck per-pixel", device, say)
    return measured, launches, ms


# ------------------------------ the untiled path and the remaining raster modes


# card float32 against CPU float64: the z-buffer's bound. A triangle's depth plane z0·x + (z1·y + z2) is made from
# float32 barycentric matrices and evaluated at pixel coordinates up to 511, and lands 1.3e-4 from float64 on
# the bench scene (NVIDIA H100 80GB HBM3); float32 against float32 (the kernels against their plain versions)
# the bound stays 1e-5
LIMIT_Z_F32_VS_F64 = 1e-3
# card float32 against CPU float64 on the untiled bench: the pixels where the two take different sides of a band's
# or a triangle's edge (a jump of the blend, or another winner), as a share of the frame (79 of 262144 at σ = 1)
MAX_F32_BOUNDARY_SHARE = 1e-3
# σ = 0, untiled against tiled: the pixels where the rational range and the plane test may take different sides
# of an edge (within ~2 ulp), as a share of the frame
MAX_BOUNDARY_SHARE = 1e-4


def to_cpu64(scene):
    """``scene`` on the CPU in float64."""
    return dataclasses.replace(scene, **{
        f.name: v.to("cpu", torch.float64 if v.is_floating_point() else v.dtype)
        for f in dataclasses.fields(scene) for v in [getattr(scene, f.name)] if isinstance(v, torch.Tensor)})


def planner_window(scene, sigma):
    """The sequential edge pass's window by the planner's rule
    (``deodr_tpu_torch.scene.edge_window``): the largest band over the
    active silhouette edges."""
    from deodr_tpu_torch.ops.render import prepare
    from deodr_tpu_torch.scene import edge_window

    with torch.no_grad():
        ij_off, signed_area, _, _ = prepare(scene)
        active = (scene.edgeflags & (signed_area > 0)[:, None]).reshape(-1)
        f = scene.faces
        span = (ij_off[f[:, [1, 2, 0]].reshape(-1)] - ij_off[f[:, [0, 1, 2]].reshape(-1)]).abs() * active[:, None]
    return edge_window(float(span[:, 1].max()), float(span[:, 0].max()), sigma, scene.height, scene.width)


def check_against(tag, got, want, say, limit_out=1e-4, limit_z=1e-5, limit_grad=1e-3):
    """Output, z-buffer (coverage equal) and gradients of ``got`` against
    ``want``, each a dict with "out", "z" and gradients under other keys."""
    fin = torch.isfinite(want["z"])
    check(torch.equal(fin, torch.isfinite(got["z"].to(fin.device))), f"{tag}: coverage differs")
    fin = fin.cpu()
    e_o, e_z = max_err(got["out"].cpu(), want["out"].cpu()), max_err(got["z"].cpu()[fin], want["z"].cpu()[fin])
    grads = [k for k in want if k not in ("out", "z")]
    errs = {k: rel_err(got[k].cpu(), want[k].cpu()) for k in grads}
    say(f"{tag}: out err {e_o:.3g} (limit {limit_out:g}), z err {e_z:.3g} (limit {limit_z:g}), covered pixels "
        f"{int(fin.sum())}; gradient err of scale (limit {limit_grad:g}): "
        + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()))
    check(all(bool(torch.isfinite(got[k]).all()) and float(got[k].abs().max()) > 0 for k in grads),
          f"{tag}: a gradient is non-finite or all zero")
    check(e_o <= limit_out and e_z <= limit_z and all(v <= limit_grad for v in errs.values()),
          f"{tag}: outside its tolerance")


def run_untiled_bench(scene, tiling, obs, device, say):
    """Phase 6a; returns the median step ms per σ."""
    from deodr_tpu_torch import render_scene
    from deodr_tpu_torch.ops import kernels

    window = planner_window(scene, 1.0)
    say(f"untiled bench: aa_window={window} (the planner's rule)")
    scene64, obs64 = to_cpu64(scene), obs.to("cpu", torch.float64)
    card64 = dataclasses.replace(scene64, **{f.name: getattr(scene64, f.name).to(device)
                                             for f in dataclasses.fields(scene64)
                                             if isinstance(getattr(scene64, f.name), torch.Tensor)})

    def run_once(s, o, sigma, error_mode, impl, weight=None):
        out, _, g_ij, g_c, z = loss_and_grads(s, sigma, None, o, error_mode, impl, with_z=True, weight=weight,
                                              aa_window=window)
        return dict(out=out, z=z, ij=g_ij, colors=g_c)

    kernels.reset_launches()
    failures = []
    for sigma in (0.0, 1.0):
        for error_mode in (False, True):
            tag = f"untiled bench sigma={sigma:g} {'error' if error_mode else 'image'} mode"
            t0 = time.perf_counter()
            want = run_once(scene64, obs64, sigma, error_mode, "reference")
            say(f"{tag}: the CPU's float64 run took {time.perf_counter() - t0:.1f} s")
            try:  # every mode's numbers are printed before a miss fails the run
                check_against(f"{tag}, card float64 vs CPU float64", run_once(card64, obs64.to(device), sigma,
                                                                            error_mode, "kernel"), want, say,
                              1e-9, 1e-9, 1e-9)
                got = run_once(scene, obs, sigma, error_mode, "kernel")
                # pixels where float32 and float64 take different sides of a band's or a triangle's edge (a jump)
                diff = (got["out"].cpu().double() - want["out"]).abs()
                boundary = (diff.amax(dim=-1) if diff.ndim == 3 else diff) > 1e-4
                boundary |= torch.isfinite(got["z"].cpu()) != torch.isfinite(want["z"])
                n_b = int(boundary.sum())
                say(f"{tag}, card float32 vs CPU float64: {n_b} boundary pixels (bound {MAX_F32_BOUNDARY_SHARE:g} "
                    f"of {scene.height * scene.width}), left out of the loss on both sides")
                check(n_b <= MAX_F32_BOUNDARY_SHARE * scene.height * scene.width, f"{tag}: too many boundary pixels")
                if n_b:
                    keep = (~boundary).double()
                    got = run_once(scene, obs, sigma, error_mode, "kernel", keep.to(device, torch.float32))
                    want = run_once(scene64, obs64, sigma, error_mode, "reference", keep)
                    for d in (got, want):
                        d["out"] = d["out"].cpu().double() * (keep if d["out"].ndim == 2 else keep[..., None])
                        d["z"] = torch.where(boundary, 0.0, d["z"].cpu().double())
                check_against(f"{tag}, card float32 vs CPU float64", got, want, say, limit_z=LIMIT_Z_F32_VS_F64)
            except Failure as e:
                failures.append(str(e))
    check(not failures, "; ".join(failures))
    launched = {k: v for k, v in kernels.LAUNCHES.items() if v}
    say(f"launches on the untiled path: {launched or 'none'} (its passes are plain PyTorch, as in the JAX package)")
    check(not launched, "the untiled path launched a hand kernel")
    with torch.no_grad():
        img_u = render_scene(scene, 0.0)[0]
        img_t = render_scene(scene, 0.0, tiling=tiling)[0]
    differ = int(((img_u - img_t).abs().amax(dim=-1) > 1e-4).sum())
    say(f"untiled against tiled at sigma=0: {differ} pixels differ by more than 1e-4 (bound "
        f"{MAX_BOUNDARY_SHARE:g} of {scene.height * scene.width}: the rational and the plane coverage near an edge)")
    check(differ <= MAX_BOUNDARY_SHARE * scene.height * scene.width, "untiled and tiled coverage differ too often")
    ms = {}
    for sigma in (0.0, 1.0):
        def step(sigma=sigma):
            loss_and_grads(scene, sigma, None, obs, False, "kernel", check_capacity=False, aa_window=window)

        ms[sigma] = median_step_ms(step, device, reps=5)
        say(f"untiled bench fwd+bwd step sigma={sigma:g}: median {ms[sigma]:.4f} ms (5 steps), "
            f"{scene.height * scene.width / (ms[sigma] * 1e-3) / 1e6:.2f} Mpix/s")
        profile_step(step, f"untiled bench sigma={sigma:g}", device, say, steps=1)
    return ms


def run_bench_nonstrict(scene, tiling, obs, device, say):
    """Phase 6b; returns (measurements, launches, median step ms)."""
    from deodr_tpu_torch.ops import kernels

    scene = dataclasses.replace(scene, strict_edge=False)
    measured = check_raster_kernels(scene, tiling, device, say, torch.Generator(device="cpu").manual_seed(6))
    kernels.reset_launches()
    main_path(scene, tiling, obs, say, name="non-strict bench")
    launches = dict(kernels.LAUNCHES)
    say(f"launches on the non-strict bench path: {launches}")
    for name in ("raster_fwd", "raster_bwd", "edge_fwd", "edge_bwd"):
        check(device.type != "cuda" or launches[name] > 0, f"{name} was never launched on the non-strict bench path")

    def step():
        loss_and_grads(scene, 1.0, tiling, obs, False, "kernel", check_capacity=False)

    ms = median_step_ms(step, device)
    say(f"non-strict bench fwd+bwd step sigma=1: median {ms:.4f} ms")
    profile_step(step, "non-strict bench sigma=1", device, say)
    return measured, launches, ms


def run_duck_persp(device, say):
    """Phase 6c; returns (measurements, launches, median step ms)."""
    from deodr_tpu_torch import duck_scene as ds
    from deodr_tpu_torch.ops import kernels

    _, scene, obs = duck_setup(device)
    scene = dataclasses.replace(scene, perspective_correct=True)
    window = planner_window(scene, ds.DUCK_SIGMA)
    say(f"perspective duck: aa_window={window} (the planner's rule)")
    measured = check_raster_kernels(scene, ds.DUCK_TILING, device, say, torch.Generator(device="cpu").manual_seed(7))
    kernels.reset_launches()
    duck_main_path(scene, obs, say, aa_window=window)
    launches = dict(kernels.LAUNCHES)
    say(f"launches on the perspective duck's path: {launches} (its textured edges take the sequential pass)")
    for name in ("raster_fwd", "raster_bwd"):
        check(device.type != "cuda" or launches[name] > 0, f"{name} was never launched on the perspective duck")
    check(launches["edge_tex_fwd"] == 0, "a perspective edge reached the textured edge kernel")

    def step():
        duck_loss_and_grads(scene, obs, "kernel", aa_window=window)

    ms = median_step_ms(step, device, reps=3)
    say(f"perspective duck fwd+bwd step: median {ms:.4f} ms (3 steps)")
    profile_step(step, "perspective duck", device, say, steps=1)
    return measured, launches, ms


def torus_mesh(textured, n=8, m=12, tex_size=256, seed=0):
    """A closed torus of 2·n·m faces (192 by default, under the 257 from
    which the planner tiles), vertices jittered from ``seed``, with a
    ``tex_size``² random texture over a seamed uv grid or per-vertex colors,
    tilted by 55° and 10° → (ColoredTriMesh with float64 CPU vertices,
    vertices as numpy)."""
    from deodr_tpu_torch.geometry.mesh import ColoredTriMesh

    rng = np.random.RandomState(seed)
    tt, pp = np.meshgrid(2 * np.pi * np.arange(n) / n, 2 * np.pi * np.arange(m) / m, indexing="ij")
    ring = 1 + 0.4 * np.cos(pp)
    vertices = np.stack([ring * np.cos(tt), ring * np.sin(tt), 0.4 * np.sin(pp)], axis=-1).reshape(-1, 3)
    vertices = vertices + rng.uniform(-0.01, 0.01, vertices.shape)
    a, b = np.deg2rad(55.0), np.deg2rad(10.0)  # tilted, so that the view is oblique
    rot = (np.array([[1, 0, 0], [0, np.cos(a), -np.sin(a)], [0, np.sin(a), np.cos(a)]])
           @ np.array([[np.cos(b), -np.sin(b), 0], [np.sin(b), np.cos(b), 0], [0, 0, 1]]))
    vertices = vertices @ rot.T
    i, j = (a.ravel() for a in np.meshgrid(np.arange(n), np.arange(m), indexing="ij"))

    def quads(vid):
        return np.concatenate([np.stack([vid(i, j), vid(i + 1, j), vid(i + 1, j + 1)], 1),
                               np.stack([vid(i, j), vid(i + 1, j + 1), vid(i, j + 1)], 1)]).astype(np.int32)

    faces = quads(lambda a, b: (a % n) * m + b % m)
    faces_uv = quads(lambda a, b: a * (m + 1) + b)
    tri = vertices[faces]
    if np.einsum("ij,ij->i", tri[:, 0], np.cross(tri[:, 1], tri[:, 2])).sum() < 0:
        faces, faces_uv = faces[:, ::-1].copy(), faces_uv[:, ::-1].copy()
    if textured:
        ui, vj = np.meshgrid(np.arange(n + 1), np.arange(m + 1), indexing="ij")
        uv = np.stack([ui.ravel() * 15.0 + 3.3, vj.ravel() * 20.0 + 2.7], axis=1)
        kw = dict(faces_uv=faces_uv, uv=uv, texture=rng.rand(tex_size, tex_size, 3))
    else:
        kw = dict(colors=rng.rand(len(vertices), 3))
    return ColoredTriMesh(faces, torch.from_numpy(vertices), **kw), vertices


def run_scene3d_untiled(device, say):
    """Phase 6d; returns the median step ms per mesh."""
    from deodr_tpu_torch import duck_scene as ds
    from deodr_tpu_torch.camera import default_camera
    from deodr_tpu_torch.ops import kernels
    from deodr_tpu_torch.scene import Scene3D

    ms = {}
    for textured in (True, False):
        tag = f"Scene3D torus ({'textured' if textured else 'untextured'}, untiled)"
        mesh, vertices = torus_mesh(textured)
        camera = default_camera(ds.DUCK_WIDTH, ds.DUCK_HEIGHT, 60, vertices, np.diag([1.0, -1.0, -1.0]))
        scenes = {}
        for key, dev, dtype, impl in (("card", device, torch.float32, "kernel"), ("card64", device, torch.float64,
                                                                                  "kernel"),
                                      ("cpu", "cpu", torch.float64, "reference")):
            m, _ = torus_mesh(textured)
            m.set_vertices(m.vertices.to(dev, dtype))
            scene = Scene3D(sigma=1.0, device=dev, impl=impl)
            scene.set_mesh(m)
            scene.set_light(np.array(ds.LIGHT_DIRECTIONAL), ds.LIGHT_AMBIENT)
            scene.set_background_color(np.array(ds.BACKGROUND_COLOR))
            scenes[key] = scene
        plan = scenes["card"]._eager_plan(camera)
        say(f"{tag}: {mesh.nb_faces} faces, plan aa_edge_capacity={plan[0]}, tiling={plan[1]}, aa_window={plan[2]}, "
            f"aa_tex_window={plan[3]}")
        check(plan[1] is None, f"{tag}: the plan has a tiling")
        obs = torch.from_numpy(np.random.RandomState(8).rand(ds.DUCK_HEIGHT, ds.DUCK_WIDTH, 3))

        def step(scene):
            image, z = scene.render(camera, return_z_buffer=True, check_capacity=True)
            scene.render_backward(2 * (image - obs.to(image.device, image.dtype)))
            out = dict(out=image, z=z, vertices=scene.mesh._vertices_b, light_directional=scene.light_directional_b,
                       light_ambient=scene.light_ambient_b)
            if textured:
                out.update(uv=scene.mesh.uv_b, texture=scene.mesh.texture_b)
            else:
                out.update(vertices_colors=scene.mesh.vertices_colors_b)
            return out

        kernels.reset_launches()
        got = step(scenes["card"])
        check(not any(kernels.LAUNCHES.values()), f"{tag}: a hand kernel was launched")
        check(all(v.device.type == device.type and bool(torch.isfinite(v if k != "z" else v[torch.isfinite(v)]).all())
                  for k, v in got.items()), f"{tag}: a result left the card or is not finite")
        check(int(torch.isfinite(got["z"]).sum()) > 0.05 * ds.DUCK_WIDTH * ds.DUCK_HEIGHT,
              f"{tag}: the torus covers under 5 % of the frame")
        got64 = step(scenes["card64"])
        t0 = time.perf_counter()
        want = step(scenes["cpu"])
        say(f"{tag}: the CPU's float64 reference took {time.perf_counter() - t0:.1f} s")
        # in float64 on both: in float32 a band or texel edge falls on the other side at a few pixels
        check_against(f"{tag}, card float64 vs CPU float64", got64, want, say, 1e-9, 1e-9, 1e-9)
        ms[tag] = median_step_ms(lambda: step(scenes["card"]), device, reps=3)
        say(f"{tag} step (render + render_backward): median {ms[tag]:.4f} ms (3 steps)")
        profile_step(lambda: step(scenes["card"]), tag, device, say, steps=2)
    return ms


def run(device="cuda", height=512, width=512, n_tri=200, smi_line=None):
    """All phases; raises on any miss. Returns the kernels record and the
    step times. A smaller bench scene only serves a rehearsal on the CPU;
    the duck always runs at its full size, which its plan is made for."""
    from deodr_tpu_torch.ops import kernels

    device = torch.device(device)

    t_start = time.perf_counter()

    def say(msg):
        print(f"[{time.perf_counter() - t_start:7.2f} s] {msg}", flush=True)

    # 1. device
    if device.type == "cuda":
        say(f"device: {torch.cuda.get_device_name(0)}")
    # as nvidia-smi prints it, on a line of its own
    print(smi_line if smi_line is not None else "nvidia-smi: not run (rehearsal on the CPU)", flush=True)

    # 2. build
    if device.type == "cuda":
        t0 = time.perf_counter()
        path = kernels.build()
        kernels.library()
        say(f"build: {path.name} in {time.perf_counter() - t0:.1f} s")

    # 3. the untextured path on the bench scene
    _, scene, tiling, obs = bench_setup(device, height, width, n_tri)
    say(f"tiling: {tiling}")

    measured = {"bench": check_kernels(scene, tiling, obs, device, say)}

    # the main path, with launch counts zeroed just before and read just after
    kernels.reset_launches()
    main_path(scene, tiling, obs, say)
    launches = {"bench": dict(kernels.LAUNCHES)}
    say(f"launches on the main path: {launches['bench']}")
    for name in ("raster_fwd", "raster_bwd", "edge_fwd", "edge_bwd"):
        check(device.type != "cuda" or launches["bench"][name] > 0, f"{name} was never launched on the main path")

    train(scene, tiling, device, say)
    ms = step_times(scene, tiling, obs, device)
    for sigma, t in ms.items():
        say(f"fwd+bwd step sigma={sigma:g}: median {t:.4f} ms, {height * width / (t * 1e-3) / 1e6:.2f} Mpix/s")
    profile_step(lambda: loss_and_grads(scene, 1.0, tiling, obs, False, "kernel", check_capacity=False),
                 "sigma=1", device, say)

    # 4. the textured path on the duck
    measured["duck"], launches["duck"], ms["duck"] = run_duck(device, say)

    # 5. Scene3D on the duck, with and without the quad fetch (kernel B4)
    scene3d_measured, scene3d_launches, ms["scene3d"] = run_scene3d(device, say)
    measured.update(scene3d_measured)
    launches.update(scene3d_launches)

    # 6. the untiled path and the remaining raster modes
    ms["untiled_bench"] = run_untiled_bench(scene, tiling, obs, device, say)
    measured["bench_nonstrict"], launches["bench_nonstrict"], ms["bench_nonstrict"] = run_bench_nonstrict(
        scene, tiling, obs, device, say)
    measured["duck_persp"], launches["duck_persp"], ms["duck_persp"] = run_duck_persp(device, say)
    ms["scene3d_untiled"] = run_scene3d_untiled(device, say)

    # 7. kernels line: one record per kernel and main path that launches it (the raster kernels
    # run on all six, with 3 attribute planes on the bench scene, 7 on the duck and 8 on the perspective
    # duck), with the device times of every kernel and yardstick measured in one profiler session
    # key → (function, the hand kernel it launches): a wrapper launches the kernel of its name
    fns = {(id(m), f): (m[f], f"{name}_kernel") if f == "device_fn" else m[f]
           for per_kernel in measured.values() for name, m in per_kernel.items()
           for f in ("device_fn", "library_device_fn", "library_device_less_fn") if f in m}
    t0 = time.perf_counter()
    times = device_times(fns, device)
    say(f"device times of {len(fns)} functions in one profiler session: {time.perf_counter() - t0:.1f} s")

    def device_time(m, f):
        return times.get((id(m), f), (None, None))[0]

    # a wrapper launches its kernel and nothing else (edge_tex_bwd: and g_texture's zero-fill)
    for path_name, per_kernel in measured.items():
        for name, expected in (("raster_fwd", 1), ("raster_bwd", 1), ("edge_fwd", 1), ("edge_bwd", 1),
                               ("edge_tex_fwd", 1), ("edge_tex_bwd", 2), ("quad_blend_fwd", 1),
                               ("quad_blend_bwd", 1)):
            if name in per_kernel:
                n_ops = times[(id(per_kernel[name]), "device_fn")][1]
                say(f"{name} on {path_name}: {'not measured' if n_ops is None else f'{n_ops:g}'} device operations "
                    f"per wrapper call (expected {expected})")
                check(device.type != "cuda" or n_ops == expected,
                      f"{name} is not {expected} device operation(s) per wrapper call on {path_name}")

    def library_device_ms(m):
        t = device_time(m, "library_device_fn")
        less = device_time(m, "library_device_less_fn") if "library_device_less_fn" in m else 0.0
        return None if t is None or less is None else max(t - less, 0.0)

    record = []
    for name in kernels.KERNEL_NAMES:
        source, replaces = KERNEL_SOURCES[name]
        for path_name in KERNEL_PATHS[name]:
            m = measured[path_name][name]
            record.append(dict(
                name=name, path=path_name, route="cuda", source=source, replaces=replaces,
                launches=launches[path_name][name], max_abs_err=m["max_abs_err"], ms=m["ms"], plain_ms=m["plain_ms"],
                bound_ms=m["bound"][0], bound_by=m["bound"][1], library_ms=m.get("library_ms"),
                device_ms=device_time(m, "device_fn"), library_device_ms=library_device_ms(m),
            ))
    print(json.dumps({"kernels": record}), flush=True)
    return record, ms


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke run needs one CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    try:
        run("cuda", smi_line=smi)
    except Failure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    torch.cuda.synchronize()
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
