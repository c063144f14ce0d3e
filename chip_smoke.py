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
7. the hand fitters (``deodr_tpu_torch.mesh_fitter`` through the scripts
   of ``deodr_tpu_torch.examples``, on ``data/``'s hand): (a) the depth fit
   (200×200, one channel, k1 = 1), 50 steps in float64 (its peak device
   memory over set-up and 50 steps printed first, from a run of its own),
   its energy at iteration 49 within 1e-3 of the golden 251.31652686512888,
   the median
   step and one profiled step, then 50 steps in float32 (finite and
   falling; its energy at 49 printed beside the golden); (b) the RGB fit
   (200 wide × 199 high, k1 = −1), 50 steps in float64, held to what a run
   of a chaotic fit can show: its first 5 energies against the same fit in
   float64 on the CPU (relative difference at most 1e-12 · 10^k at step k),
   and its energy at 49 below a bar (2400, and 0.62 of the energy at 0) set
   from 16 card runs of ``deodr_tpu_torch/examples/rgb_fit_spread.py``; the
   energy at 49 is printed beside both bands of
   tests/test_rgb_image_hand_fitting.py, unchecked; median and profiled
   step; (c) the
   multi-view fit (three 200 × 283 views), 12 steps, the last energy below
   0.75× the first; (d) the L-BFGS depth fit, 8 steps, the last below 0.6×
   the first. On each, launch counts are zeroed before and read after:
   B1 and B2 forward and backward launched once a render (the fitter's
   step runs times its frames, or the energy module's evaluations), and no
   textured edge or quad-blend kernel. B1 and B2 are held against their
   plain versions on the tables of the depth fit (C = 1) and the RGB fit
   (C = 3) at their final state, with their own plans, in float64 (the
   bounds in float64: PEAK_F64_OPS_S);
8. the scenes: (a) ``Scene2D`` on the triangle soup of
   ``deodr_tpu_torch.examples.triangle_soup_fitting`` (30 triangles,
   200×200, float64, untiled: no hand kernel): the ground truth at σ = 1
   within 1 of tests/data/triangle_soup.png (×255), the fit in image mode
   for 60 iterations (the loss at 59 below 0.35× the loss at 0) and in
   error mode for 5, each one's first 5 losses against the same fit on the
   CPU (1e-9 relative; the CPU's fits run in a process of their own while
   the card works), the median step and one profiled step; (b) the
   eigen-faces fit (20 iterations, below 0.5× the first energy) and the
   textured-grid fit at size 48 (40 iterations, below 0.25×), their first
   3 energies against the CPU's; (c) the duck through
   ``deodr_tpu_torch.examples.render_mesh``: ``example_rgb`` at 320×240
   against data/test/duck.png (at most 3 pixels off by 1/255, none by
   2/255; float32 first, float64 where float32 misses), and
   ``render_deferred`` at 640×480 (tiled, σ = 0, float64, 14 planes): the
   raster forward against its plain version on its tables (slot map
   exact, planes within 1e-9 of scale), the channels against
   ``impl="reference"`` (1e-9 of scale) and the contracts of
   tests/test_fitters_more.py, one launch of the raster forward and no
   other; (d) ``Scene2D`` above 256 faces (the bench scene's fields at 512
   triangles, float64, every edge flagged, σ = 1, the plan of
   ``_plan_tiling``): ``render_compare_and_backward`` in image and error
   mode against ``impl="reference"`` (image, z, err, ``ij_b``,
   ``colors_b`` within 1e-9), each render launching B1 and B2 forward and
   backward once; the median step, one profiled step, and B1 and B2 against
   their plain versions on its tables;
9. large meshes: ``Scene3D`` on ``octahedron_mesh(level)`` as
   ``tools/size_sweep.py`` builds it (float32; LARGE_SCENES): level 5
   (8192 faces) at 2048², σ = 0, planned with supertiles; level 6 at 1024²,
   σ = 1, and level 7 (131072 faces) at 2048², σ = 1 and 0, planned with
   pair binning. Each: the plan printed and its binner checked; one
   ``render`` + ``render_backward`` with ``check_capacity=True`` (no bin
   overflows), its launches zeroed before and read after (B1f, B2f and B2b
   once, B1b as many times as ``raster_bwd_batches`` predicts, no B3/B4);
   ``render_scene`` with the plan against the same plan with dense binning
   on the same buffers, in float32 (image and z within 1e-6,
   bit-equality reported; gradients to ij and colors within 1e-2 of scale,
   beside the spread of two dense runs: float atomics) and in float64
   (within 1e-9 of scale); at level 7 σ = 1 the float64 render and
   gradients against ``impl="reference"`` (1e-9 of scale) and B1 and B2
   against their plain versions on its tables (the ``large_mesh`` records); the median Scene3D step of 10 and Mpix/s,
   one profiled step, and the binning's device time (binner and dense) as
   profiler groups. Then B1b split where one launch's table does not fit
   a block's shared memory: the exploded duck at 320×240 (float64, D = 14,
   capacity 1024) through ``render_scene`` with a backward against
   ``impl="reference"`` (1e-9 of scale, one launch a batch), and slot
   windows at capacity 16384 (float64, D = 1) against the plain version;
10. scale-out and auxiliaries: (a) the bench scene's tile-sharded fwd+bwd
   (``deodr_tpu_torch.parallel``) at world size 1 on NCCL in this process
   (float64 image and z bit-equal to ``render_scene``'s, gradients within
   1e-12 of scale) and at world size 2 on gloo, two spawned ranks sharing
   the card (float64 within 1e-9 of the single-process render; float32
   bit-equal in image and z to the same bands rendered in one process,
   gradients within 1e-2 of scale beside the spread of two such runs, and
   the pixels whose coverage differs from the unsharded render bounded);
   B1f, B1b, B2f and B2b launched in each rank, one all-gather forward and
   one all-reduce of the ij and colors gradients backward; the sharded and
   the single-process step's median; (b) in the same ranks the duck's
   textured multi-view step (float64, 4 views, 2 a rank) against the
   sequential sum of the views' losses and gradients (1e-9), its one
   all-reduce exactly texture + uv + shade + loss, B1 and B3 launched in
   each rank; (c) the view-sharded multi-frame fitter (4 frames of
   ``octahedron_mesh(3)``, 3 steps) against the sequential fitter; (d) 30
   iterations of the Adam depth fit (last energy below 0.85 of the first)
   and its ms per iteration; (e) a batch of 4 bench scenes through
   ``render_scene_batch`` against 4 single renders (each kernel launched 4
   times); (f) 10 frames of the headless viewer on the duck across its
   toggles, each within one level of the same view with
   ``impl="reference"``, and its frames per second. The ranks run
   ``scale_out_rank``; a rank that fails fails the run;
11. the torch class surface (``deodr_tpu_torch.interop``): (a)
   ``Scene3DTorch`` on the duck (640×480, 4212 faces, textured, σ = 1,
   through ``CameraTorch.from_camera`` on phase 5's camera): one forward
   and backward of Σ (image − obs)² to the vertices, the lights, uv and
   texture in float32, B1f, B1b, B3f and B3b launched (counts zeroed
   before and read after), against the same call with
   ``impl="reference"`` (image within 1e-4, gradients within 1e-3 of
   scale), and in float64 against the port's ``Scene3D`` on the same mesh,
   camera and lights (``render`` + ``render_backward``: image and
   gradients within 1e-9 of scale); (b) the same on the hand of the RGB
   fit (1048 faces, vertex colours, 200 wide × 199 high, k1 = −1, against
   its image), B1f, B1b, B2f and B2b launched; (c) ``render_scene_torch``
   on the hand's float64 buffers against ``render_scene`` on the plan of
   ``plan_tiling`` (image bit-equal, gradients within 1e-12 of scale: the
   order of float atomics); (d) 20 steps of ``torch.optim.Adam`` on the
   duck's vertices, light and texture from a seeded perturbation towards
   the unperturbed render (the last loss below the first) and the median
   step beside phase 5's ``Scene3D`` step. Its kernels run at the shapes
   of the ``duck_scene3d`` and ``rgb_fit`` records, so it adds no record;
12. one JSON line ``{"kernels": [...]}``, one record per kernel and main path
   that launches it (launches on that path, error, times, the least time the
   card could take at that path's shapes): 47 records over the paths
   ``bench``, ``duck``, ``duck_scene3d``, ``duck_quad``, ``bench_nonstrict``,
   ``duck_persp``, ``depth_fit``, ``rgb_fit``, ``scene2d``,
   ``deferred_duck``, ``large_mesh``, ``sharded_bench`` (rank 0's band)
   and ``multiview_duck`` (float64). ``ms`` times calls
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
13. last line ``{"ok": true, "device": {...}}``.

The scenes come from ``deodr_tpu_torch.bench_scene`` (numpy, seed 0, as
``bench.py`` builds it), ``deodr_tpu_torch.duck_scene`` (``data/duck.obj``
and its texture) and the fitters' examples (``data/hand.obj``,
``depth.bin``, ``hand.png``, ``hand_multiview/``) and the 2D examples
(``trefle.jpg``, the soup's and the duck's golden images); nothing of JAX
or of the JAX package is imported.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and float32 (non-tensor-core) rate
PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12
# float64 (non-tensor-core) rate, the same data sheet: the fitters' kernels run in float64
PEAK_F64_OPS_S = 34e12
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
# the depth fit (200x200, one channel) and the RGB fit (200 wide, 199 high, 3 channels), float64
FIT_PATHS = ("depth_fit", "rgb_fit")
# "scene2d" is Scene2D above 256 faces (the tiled route, float64), "deferred_duck" Scene3D.render_deferred on the duck
# (forward only, 14 attribute planes, float64), "large_mesh" Scene3D on octahedron_mesh(7) at 2048² (pair binning,
# float32)
# "sharded_bench" is the bench's tile-sharded render over 2 ranks (its kernels measured on rank 0's band, 256 rows),
# "multiview_duck" the duck's textured multi-view step over 2 ranks (float64, 2 views a rank)
KERNEL_PATHS = {"raster_fwd": ("bench",) + DUCK_PATHS + MODE_PATHS + FIT_PATHS + ("scene2d", "deferred_duck",
                                                                                  "large_mesh", "sharded_bench",
                                                                                  "multiview_duck"),
                "raster_bwd": ("bench",) + DUCK_PATHS + MODE_PATHS + FIT_PATHS + ("scene2d", "large_mesh",
                                                                                  "sharded_bench", "multiview_duck"),
                "edge_fwd": ("bench",) + FIT_PATHS + ("scene2d", "large_mesh", "sharded_bench"),
                "edge_bwd": ("bench",) + FIT_PATHS + ("scene2d", "large_mesh", "sharded_bench"),
                "edge_tex_fwd": DUCK_PATHS + ("multiview_duck",), "edge_tex_bwd": DUCK_PATHS + ("multiview_duck",),
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
    from deodr_tpu_torch.profiling import device_profile

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
        with device_profile() as prof:
            for fn, _ in fns.values():  # the warm-up group: a session can miss its first tens of device events
                for _ in range(reps):
                    fn()
            torch.cuda.synchronize()
            for fn, _ in fns.values():
                time.sleep(0.01)
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
        ops = [(start, start + dur, name) for start, dur, name in prof.events]
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


def bound_ms(n_bytes: float, n_ops: float, itemsize: int = 4):
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S, n_ops / (PEAK_F64_OPS_S if itemsize == 8 else PEAK_F32_OPS_S)
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


def check_raster_kernels(scene, tiling, device, say, gen, limit_z=1e-5, limit_vals=1e-4, vals_of_scale=False,
                         backward=True):
    """The raster kernels against their plain versions on ``scene``'s
    tables, in the scene's coverage (``strict_edge``) and depth
    (``perspective_correct``) modes: slot map exact, z within ``limit_z``,
    attribute planes within ``limit_vals`` (of their scale with
    ``vals_of_scale``); the backward kernel too unless the path is forward
    only (``backward=False``); returns their measurements."""
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
        e_v_check = rel_err(v_k, v_ref) if vals_of_scale else e_v
        say(f"raster_fwd (D = {d}, {mode}, {v_ref.dtype}): slot_map exact, z err {e_z:.3g} (limit {limit_z:g}), vals "
            f"err {e_v:.3g}" + (f", {e_v_check:.3g} of scale" if vals_of_scale else "")
            + f" (limit {limit_vals:g}{' of scale' if vals_of_scale else ''})")
        check(e_z <= limit_z and e_v_check <= limit_vals, "raster_fwd outside its tolerance")
        rows = int(rt.counts.to(torch.int64).clamp(max=cap_r).sum())
        p_total = grid.n_tiles * n_px
        cull_line("raster_fwd", rk, rt.setup_tile, rt.counts, grid, visits, say, strict=mode["strict"])
        out["raster_fwd"] = dict(
            max_abs_err=max(e_z, e_v),
            ms=time_ms(fwd, 50, device),
            device_fn=fwd,
            plain_ms=time_ms(lambda: fwd("reference"), 3, device),
            bound=bound_ms(rows * (22 + 3 * d) * esz + grid.n_tiles * 4 + p_total * (4 + esz * (1 + d)),
                           visits * ops_per_visit + p_total * 4 * d, esz),
        )

        if not backward:
            return out
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
            bound=bound_ms(p_total * (4 + esz * d) + rows * 3 * d * esz, p_total * 6 * d, esz),
        )
        # the kept bound writes the used rows only; the kernel also writes the zero rows up to cap
        full = bound_ms(p_total * (4 + esz * d) + grid.n_tiles * cap_r * 3 * d * esz, p_total * 6 * d, esz)[0]
        say(f"raster_bwd bound {out['raster_bwd']['bound'][0]:.5f} ms with the {rows} used rows written, "
            f"{full:.5f} ms with all {grid.n_tiles} x {cap_r} rows written")
    return out


def check_kernels(scene, tiling, obs, device, say, edge_cap=AA_EDGE_CAPACITY):
    """Each kernel of the untextured path against its plain version at the
    shapes of ``scene`` (the bench scene's, or a fitter's with its
    ``edge_cap``); returns per-kernel measurements."""
    from deodr_tpu_torch.ops.kernels import edge_kernel as ek

    gen = torch.Generator(device="cpu").manual_seed(1)
    out = check_raster_kernels(scene, tiling, device, say, gen)
    with torch.no_grad():
        esz = scene.ij.element_size()
        inputs = edge_inputs(scene, tiling, obs, 1.0, edge_cap)
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
                                   e_visits * OPS_PER_VISIT["edge_fwd"], esz),
                )
                out["edge_bwd"].update(
                    ms=time_ms(lambda: ek.edge_bwd(*bargs), 20, device),
                    device_fn=lambda bargs=bargs: ek.edge_bwd(*bargs),
                    plain_ms=time_ms(lambda: ek.edge_bwd(*bargs, impl="reference"), 3, device),
                    bound=bound_ms(e_rows * (w_row + 3 + 3 * c) * esz + p_e * esz * (3 * c + 1),
                                   e_visits * OPS_PER_VISIT["edge_bwd"], esz),
                )
                # the kept bound writes the used rows only; the kernel also writes the zero rows up to cap
                full = bound_ms(e_rows * w_row * esz + et.grid.n_tiles * e_cap * (3 + 3 * c) * esz
                                + p_e * esz * (3 * c + 1), e_visits * OPS_PER_VISIT["edge_bwd"], esz)[0]
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
    from deodr_tpu_torch.profiling import device_profile

    if device.type != "cuda":
        say(f"profile {tag}: not measured (no card)")
        return
    step()
    torch.cuda.synchronize()
    with device_profile() as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    if not prof.times:
        say(f"profile {tag}: wall {wall_ms:.4f} ms/step; device time not measured (the profiler saw no device ops)")
        return
    by_name = {name: us / 1e3 / steps for name, us in prof.times.items()}
    busy = prof.total_us / 1e3 / steps
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    say(f"profile {tag}: wall {wall_ms:.4f} ms/step (profiler on), device busy {busy:.4f} ms/step "
        f"({100 * busy / wall_ms:.2f}% of wall), {sum(prof.counts.values()) / steps:.0f} device ops/step")
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
                                   e_visits * OPS_PER_VISIT["edge_tex_fwd"], esz),
                )
                out["edge_tex_bwd"].update(
                    ms=time_ms(lambda: etk.edge_tex_bwd(*bargs), 20, device),
                    device_fn=lambda bargs=bargs: etk.edge_tex_bwd(*bargs),
                    plain_ms=time_ms(lambda: etk.edge_tex_bwd(*bargs, impl="reference"), 3, device),
                    bound=bound_ms(e_rows * (w_row + 12 + 3 * c) * esz + p_e * esz * (3 * c + 1) + 2 * tap_bytes
                                   + texture.numel() * esz,
                                   e_visits * OPS_PER_VISIT["edge_tex_bwd"], esz),
                )
                full = bound_ms(e_rows * w_row * esz + et.grid.n_tiles * e_cap * (12 + 3 * c) * esz
                                + p_e * esz * (3 * c + 1) + 2 * tap_bytes + texture.numel() * esz,
                                e_visits * OPS_PER_VISIT["edge_tex_bwd"], esz)[0]
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
    from deodr_tpu_torch import data_path
    from deodr_tpu_torch import duck_scene as ds
    from deodr_tpu_torch.camera import default_camera
    from deodr_tpu_torch.geometry.mesh import ColoredTriMesh
    from deodr_tpu_torch.scene import Scene3D

    mesh = ColoredTriMesh.load(os.path.join(data_path, "duck.obj"))
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
    equal = e_o == 0 and e_z == 0
    say(f"{tag}: out err {e_o:.3g} (limit {limit_out:g}), z err {e_z:.3g} (limit {limit_z:g}), "
        f"{'bit-equal' if equal else 'not bit-equal'}, covered pixels "
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


# ------------------------------------------------------------ the fitters


# the golden energies at iteration 49 (tests/test_depth_image_hand_fitting.py, tests/test_rgb_image_hand_fitting.py)
DEPTH_GOLDEN = 251.31652686512888
RGB_GOLDEN = 2117.377851527105
RGB_BAND = (2104.9, 2133.0)
# The RGB fit is chaotic (a last-bit change grows about tenfold a step), so the card's run is held to what a run can
# show. Its first RGB_CPU_STEPS energies against the same fit in float64 on the CPU: relative difference at most
# RGB_TRAJECTORY_LIMIT · 10^k at step k (measured on an NVIDIA H100 80GB HBM3: 0 at step 0, 1.2e-14 at step 4,
# deodr_tpu_torch/examples/rgb_fit_spread.py --compare-cpu). And convergence: the energy at iteration 49 below
# RGB_BAR and below RGB_BAR_SHARE of the energy at iteration 0 (3914.20). Over 16 card runs of rgb_fit_spread.py
# (8 from the start, 8 from starts moved by 1e-13) it ranged 2101.09-2184.98, and 8 earlier card runs reached 2253.48:
# the bar is 6.5 % above that, 0.613 of the energy at iteration 0
RGB_CPU_STEPS = 5
RGB_TRAJECTORY_LIMIT = 1e-12
RGB_BAR = 2400.0
RGB_BAR_SHARE = 0.62
FITTER_KERNELS = ("raster_fwd", "raster_bwd", "edge_fwd", "edge_bwd")


def fit(fitter, steps, say, tag):
    """``steps`` steps of ``fitter`` (their printed lines kept off the
    output) → (energies, host ms of each step: a step ends in its host
    read, so its wall time is its time)."""
    energies, ms = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            out = fitter.step()
        ms.append((time.perf_counter() - t0) * 1e3)
        energies.append(out[0] if isinstance(out, tuple) else out)
    check(all(np.isfinite(energies)), f"{tag}: a non-finite energy")
    say(f"{tag}: {steps} steps in {sum(ms) / 1e3:.3f} s, median step {statistics.median(ms):.4f} ms; energies "
        f"{energies[0]:.6f} ... {energies[-1]:.10f}")
    return energies, ms


def depth_fit_peak_mib(device, steps=50):
    """Peak device memory (MiB, ``torch.cuda.max_memory_allocated``) of
    the float64 depth fit's set-up and first ``steps`` steps; None off the
    card. From the checkout's directory with another checkout's package
    first on the path it measures that one's."""
    from deodr_tpu_torch.examples import depth_image_hand_fitting as depth_ex

    if device.type != "cuda":
        return None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fit(depth_ex.make_fitter(device=device, dtype=torch.float64), steps, lambda _: None, "depth fit")
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() / 2**20


def fitter_launches(tag, renders, device, say):
    """The launch counts since the last reset: on the card each of B1 and
    B2 forward and backward launched once a render (``renders``: the
    fitter's step runs times its frames, re-runs after a replan included),
    and no textured edge or quad-blend kernel at all."""
    from deodr_tpu_torch.ops import kernels

    launches = dict(kernels.LAUNCHES)
    say(f"launches on {tag}: {launches} ({renders} renders)")
    for name in FITTER_KERNELS:
        check(device.type != "cuda" or launches[name] == renders,
              f"{tag}: {name} launched {launches[name]} times for {renders} renders")
    others = {k: v for k, v in launches.items() if k not in FITTER_KERNELS and v}
    check(not others, f"{tag}: other kernels launched: {others}")
    return launches


def fitter_kernels(fitter, device, say, tag):
    """B1 and B2 against their plain versions on the tables of the fitter's
    render at its current state, with its last plan (the shapes of its main
    path) and its observed image."""
    cap, tiling = fitter.core.plan_guess(fitter.camera)
    with torch.no_grad():
        if hasattr(fitter, "mesh_color"):
            params = fitter._params()
            obs = fitter._tensor(fitter.mesh_image)
        else:
            params = [fitter._tensor(a) for a in (fitter.vertices, fitter.transform_quaternion,
                                                    fitter.transform_translation)]
            obs = fitter._tensor(fitter.mesh_image)[:, :, None]
        scene = fitter._buffers(*params)
    say(f"{tag} kernels: {scene.width}x{scene.height}, C = {scene.colors.shape[1]}, {scene.colors.dtype}, "
        f"aa_edge_capacity={cap}, {tiling}")
    return check_kernels(scene, tiling, obs, device, say, edge_cap=cap)


def run_fitters(device, say):
    """Phase 7; returns (measurements, launches, step ms) per fitter path."""
    from deodr_tpu_torch.examples import depth_image_hand_fitting as depth_ex
    from deodr_tpu_torch.examples import rgb_image_hand_fitting as rgb_ex
    from deodr_tpu_torch.examples import rgb_multiview_hand as multi_ex
    from deodr_tpu_torch.ops import kernels

    measured, launches, ms = {}, {}, {}

    # (a) the depth fit, float64, against its golden energy; then float32
    peak = depth_fit_peak_mib(device)
    say("depth fit float64: peak device memory "
        + ("not measured (no card)" if peak is None else f"{peak:.2f} MiB over set-up and 50 steps"))
    fitter = depth_ex.make_fitter(device=device, dtype=torch.float64)
    kernels.reset_launches()
    energies, step_ms = fit(fitter, 50, say, "depth fit float64")
    say(f"depth fit float64: energy at iteration 49 {energies[49]!r} (golden {DEPTH_GOLDEN!r}, limit 1e-3; "
        f"off by {abs(energies[49] - DEPTH_GOLDEN):.3g})")
    check(abs(energies[49] - DEPTH_GOLDEN) < 1e-3, "depth fit: energy at iteration 49 off its golden")
    profile_step(lambda: fit(fitter, 1, lambda _: None, "depth fit"), "depth fit float64", device, say, steps=3)
    launches["depth_fit"] = fitter_launches("the depth fit", fitter.core.n_runs, device, say)
    ms["depth_fit"] = statistics.median(step_ms)
    measured["depth_fit"] = fitter_kernels(fitter, device, say, "depth fit")
    fitter32 = depth_ex.make_fitter(device=device, dtype=torch.float32)
    kernels.reset_launches()
    energies32, step_ms32 = fit(fitter32, 50, say, "depth fit float32")
    say(f"depth fit float32: energy at iteration 49 {energies32[49]!r} beside the float64 golden {DEPTH_GOLDEN!r} "
        "(no bound)")
    check(energies32[-1] < energies32[0], "depth fit float32: the energy did not fall")
    profile_step(lambda: fit(fitter32, 1, lambda _: None, "depth fit"), "depth fit float32", device, say, steps=3)
    fitter_launches("the float32 depth fit", fitter32.core.n_runs, device, say)
    ms["depth_fit_f32"] = statistics.median(step_ms32)

    # (b) the RGB fit, float64: its first steps against the CPU's, and convergence at iteration 49
    fitter = rgb_ex.make_fitter(device=device, dtype=torch.float64)
    kernels.reset_launches()
    energies, step_ms = fit(fitter, 50, say, "RGB fit float64")
    cpu_energies, _ = fit(rgb_ex.make_fitter(device=torch.device("cpu"), dtype=torch.float64), RGB_CPU_STEPS,
                          say, "RGB fit float64 on the CPU")
    misses = []
    for k, (a, b) in enumerate(zip(energies, cpu_energies)):
        rel, limit = abs(a - b) / abs(b), RGB_TRAJECTORY_LIMIT * 10**k
        say(f"RGB fit step {k}: energy {a!r}, on the CPU {b!r}: relative difference {rel:.3g} (limit {limit:g})")
        if not rel <= limit:
            misses.append(k)
    bar = min(RGB_BAR, RGB_BAR_SHARE * energies[0])
    inside = RGB_BAND[0] < energies[49] < RGB_BAND[1] and abs(energies[49] - RGB_GOLDEN) < 0.005 * RGB_GOLDEN
    say(f"RGB fit float64: energy at iteration 49 {energies[49]!r} ({energies[49] / energies[0]:.4f} of iteration 0; "
        f"bar {bar:.2f}); beside the JAX bands (information, not checked: the fit is chaotic): band {RGB_BAND} and "
        f"within 0.5 % of {RGB_GOLDEN!r} (off by {abs(energies[49] - RGB_GOLDEN) / RGB_GOLDEN:.3g}): "
        f"{'inside' if inside else 'outside'}")
    profile_step(lambda: fit(fitter, 1, lambda _: None, "RGB fit"), "RGB fit float64", device, say, steps=3)
    launches["rgb_fit"] = fitter_launches("the RGB fit", fitter.core.n_runs, device, say)
    ms["rgb_fit"] = statistics.median(step_ms)
    measured["rgb_fit"] = fitter_kernels(fitter, device, say, "RGB fit")
    check(not misses, f"RGB fit: steps {misses} differ from the CPU's beyond their limits")
    check(energies[49] < bar, "RGB fit: energy at iteration 49 not below its bar (the fit did not converge)")

    # (c) the multi-view fit: three views in sequence under one plan
    fitter = multi_ex.make_fitter(device=device, dtype=torch.float64)
    kernels.reset_launches()
    energies, step_ms = fit(fitter, 12, say, "multi-view fit float64")
    check(energies[-1] < 0.75 * energies[0], "multi-view fit: the last energy is not below 0.75x the first")
    fitter_launches("the multi-view fit", fitter.core.n_runs * fitter.nb_frames, device, say)
    ms["multiview_fit"] = statistics.median(step_ms)

    # (d) the depth energy module under torch.optim.LBFGS
    fitter = depth_ex.make_fitter(optimizer="lbfgs", device=device, dtype=torch.float64)
    kernels.reset_launches()
    energies, step_ms = fit(fitter, 8, say, "L-BFGS depth fit float64")
    check(energies[-1] < 0.6 * energies[0], "L-BFGS depth fit: the last energy is not below 0.6x the first")
    fitter_launches("the L-BFGS depth fit", fitter.energy.n_evaluations, device, say)
    ms["lbfgs_fit"] = statistics.median(step_ms)
    return measured, launches, ms


# ------------------------------------------------------------ the scenes


# the triangle soup's fit: the loss at iteration 59 below this share of the loss at 0
# (tests/test_triangle_soup_fitting.py), and the texture fits' bars (tests/test_eigen_faces.py,
# tests/test_fitters_more.py)
SOUP_BAR, EIGEN_BAR, GRID_BAR = 0.35, 0.5, 0.25
# card float64 against the CPU float64 on the 2D fits' first steps, relative: the same plain PyTorch operations on
# both, so only the order of the card's float atomics (index_add_, the gathers' backward) differs
LIMIT_2D_STEPS = 1e-9
# the duck golden of tests/test_render_golden.py: at most 3 pixels off by 1/255 or more, none by 2/255
DUCK_GOLDEN_MAX_OFF = 3
DEFERRED_CHANNELS = ("depth", "face_id", "barycentric", "normal", "luminosity", "xyz", "uv")
UNTEXTURED_KERNELS = ("raster_fwd", "raster_bwd", "edge_fwd", "edge_bwd")


def hold_steps(tag, got, want, say, limit=LIMIT_2D_STEPS):
    """The losses ``got`` (card) against ``want`` (CPU), relative."""
    errs = [abs(a - b) / abs(b) for a, b in zip(got, want)]
    say(f"{tag}: first {len(want)} losses on the card {[float(v) for v in got[:len(want)]]}, relative difference to "
        f"the CPU's {max(errs):.3g} (limit {limit:g})")
    check(max(errs) <= limit, f"{tag}: the card's first steps differ from the CPU's")


def no_launches(tag, say):
    from deodr_tpu_torch.ops import kernels

    launched = {k: v for k, v in kernels.LAUNCHES.items() if v}
    say(f"launches on {tag}: {launched or 'none'} (untiled: plain PyTorch, as in the JAX package)")
    check(not launched, f"{tag} launched a hand kernel")


def cpu_references() -> dict:
    """The first losses of phase 8's 2D fits in float64 on the CPU: the
    triangle soup's 5 in image and in error mode, eigen faces' and the
    textured grid's 3."""
    from deodr_tpu_torch.examples import eigen_faces, textured_grid_fitting
    from deodr_tpu_torch.examples import triangle_soup_fitting as soup

    cpu = torch.device("cpu")
    out = {}
    for error_mode in (False, True):
        fit = soup.SoupFit(antialiase_error=error_mode, device=cpu)
        out[f"soup_{'error' if error_mode else 'image'}"] = [fit.step()[0] for _ in range(5)]
    out["eigen faces"] = eigen_faces.run(3, device=cpu)["energies"]
    out["textured grid (size 48)"] = textured_grid_fitting.run(3, size=48, device=cpu)
    return out


def start_cpu_references():
    """A process that computes :func:`cpu_references` while the card runs
    phase 8, with no card in sight → (Popen, function that waits for it and
    returns its dict)."""
    code = ("import json, torch; torch.set_num_threads(6); import chip_smoke; "
            "print(json.dumps(chip_smoke.cpu_references()))")
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=os.path.dirname(os.path.abspath(__file__)),
                            stdout=subprocess.PIPE, text=True, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    got = {}

    def result():
        if not got:
            out, _ = proc.communicate(timeout=900)
            check(proc.returncode == 0, f"the CPU references' process exited with {proc.returncode}")
            got.update(json.loads(out.strip().splitlines()[-1]))
        return got

    return proc, result


def run_soup(device, say, cpu_refs):
    """Phase 8a; returns the median step ms per mode."""
    import PIL.Image

    from deodr_tpu_torch.examples import triangle_soup_fitting as soup
    from deodr_tpu_torch.ops import kernels

    np.random.seed(2)
    scene_gt = soup.create_example_scene(clockwise=True, device=device)
    image, _ = scene_gt.render(sigma=1)
    golden = np.asarray(PIL.Image.open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data",
                                                    "triangle_soup.png"))).astype(np.float64)
    off = float(np.abs(golden - image * 255).max())
    say(f"triangle soup (Scene2D, {scene_gt.faces.shape[0]} triangles, {scene_gt.width}x{scene_gt.height}, float64, "
        f"untiled): render at sigma=1 against tests/data/triangle_soup.png: max |golden - 255 image| {off:.4g} "
        "(limit 1)")
    check(off <= 1, "triangle soup: the render is off its golden image")
    ms = {}
    for error_mode, steps in ((False, 60), (True, 5)):
        tag = f"triangle soup fit ({'error' if error_mode else 'image'} mode)"
        fit = soup.SoupFit(antialiase_error=error_mode, device=device)
        kernels.reset_launches()
        losses, step_ms = [], []
        for _ in range(steps):
            t0 = time.perf_counter()
            losses.append(fit.step()[0])
            step_ms.append((time.perf_counter() - t0) * 1e3)
        no_launches(tag, say)
        hold_steps(tag, losses, cpu_refs()[f"soup_{'error' if error_mode else 'image'}"], say)
        check(all(np.isfinite(losses)), f"{tag}: a non-finite loss")
        ms[tag] = statistics.median(step_ms)
        say(f"{tag}: {steps} steps, median step {ms[tag]:.4f} ms (host clock; a step ends in its host reads), loss "
            f"{losses[0]:.6f} -> {losses[-1]:.6f} ({losses[-1] / losses[0]:.4f} of the first)")
        if not error_mode:
            check(losses[59] < SOUP_BAR * losses[0], f"{tag}: the loss at iteration 59 is not below {SOUP_BAR}x the "
                  "loss at 0")
            profile_step(fit.step, tag, device, say, steps=1)
    return ms


def run_texture_fits(device, say, cpu_refs):
    """Phase 8b; returns the median step ms per fit."""
    from deodr_tpu_torch.examples import eigen_faces, textured_grid_fitting
    from deodr_tpu_torch.ops import kernels

    ms = {}
    for tag, fn, steps, bar in (
        ("eigen faces", lambda n, dev: eigen_faces.run(n, device=dev)["energies"], 20, EIGEN_BAR),
        ("textured grid (size 48)", lambda n, dev: textured_grid_fitting.run(n, size=48, device=dev), 40, GRID_BAR),
    ):
        kernels.reset_launches()
        t0 = time.perf_counter()
        energies = fn(steps, device)
        ms[tag] = (time.perf_counter() - t0) * 1e3 / steps
        no_launches(tag, say)
        hold_steps(tag, energies, cpu_refs()[tag], say)
        say(f"{tag}: {steps} steps in {ms[tag] * steps / 1e3:.3f} s ({ms[tag]:.4f} ms a step, set-up and the ground "
            f"truth's render included), energy {energies[0]:.6f} -> {energies[-1]:.6f} "
            f"({energies[-1] / energies[0]:.4f} of the first; bar {bar})")
        check(all(np.isfinite(energies)) and energies[-1] < bar * energies[0],
              f"{tag}: the last energy is not below {bar}x the first")
    return ms


def run_duck_examples(device, say):
    """Phase 8c; returns (measurements, launches, render ms)."""
    import PIL.Image

    from deodr_tpu_torch import data_path
    from deodr_tpu_torch.examples import render_mesh
    from deodr_tpu_torch.ops import kernels

    golden = np.asarray(PIL.Image.open(os.path.join(data_path, "test", "duck.png"))).astype(np.int64)
    for dtype in (torch.float32, torch.float64):
        image = render_mesh.example_rgb(320, 240, device=device, dtype=dtype)
        diff = np.abs(golden - (image * 255).astype(np.uint8).astype(np.int64)).max(axis=-1)
        n1, n2 = int((diff >= 1).sum()), int((diff >= 2).sum())
        held = n1 <= DUCK_GOLDEN_MAX_OFF and n2 == 0
        say(f"render_mesh.example_rgb at 320x240 in {dtype} against data/test/duck.png: {n1} pixels off by >= 1/255 "
            f"(limit {DUCK_GOLDEN_MAX_OFF}), {n2} by >= 2/255 (limit 0): "
            + ("held" if held else "missed" + (", so the float64 mesh runs" if dtype == torch.float32 else "")))
        if held:
            break
    check(held, "the duck render is off its golden image in float64 too")

    # the G-buffer at full width: render_deferred, tiled, sigma = 0, B1f at D = 14
    scene, camera = render_mesh.default_scene(os.path.join(data_path, "duck.obj"), 640, 480, device=device)
    scene.sigma = 0
    buffers, tiling, sizes = scene._deferred_buffers(camera)
    d = buffers.colors.shape[1]
    say(f"render_deferred on the duck at 640x480, {buffers.colors.dtype}: channels {sizes} (D = {d}), {tiling}")
    check(tiling is not None and d == 14, "render_deferred: not the tiled route at D = 14")
    measured = check_raster_kernels(buffers, tiling, device, say, torch.Generator(device="cpu").manual_seed(9),
                                    limit_z=1e-9, limit_vals=1e-9, vals_of_scale=True, backward=False)
    kernels.reset_launches()
    got = scene.render_deferred(camera)
    launches = dict(kernels.LAUNCHES)
    say(f"launches on render_deferred: {launches}")
    check(device.type != "cuda" or (launches["raster_fwd"] == 1 and sum(launches.values()) == 1),
          "render_deferred: not one launch of raster_fwd and no other kernel")
    reference, _ = render_mesh.default_scene(os.path.join(data_path, "duck.obj"), 640, 480, device=device,
                                             impl="reference")
    reference.sigma = 0
    want = reference.render_deferred(camera)
    check(list(got) == list(DEFERRED_CHANNELS) == list(want), f"render_deferred: channels {list(got)}")
    errs = {k: float(np.abs(got[k] - want[k]).max() / max(1.0, np.abs(want[k]).max())) for k in got}
    mask = got["barycentric"].sum(axis=2) > 0.5
    fids = got["face_id"][:, :, 0][mask]
    e_bary = float(np.abs(got["barycentric"].sum(axis=2)[mask] - 1).max())
    e_fid = float(np.abs(fids - np.round(fids)).max())
    depth_std = float(got["depth"][:, :, 0][~mask].std())
    say("render_deferred against impl='reference', err of scale (limit 1e-9): "
        + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
        + f"; covered pixels {int(mask.sum())}, barycentric sums off 1 by {e_bary:.3g} (limit 1e-6), face ids off "
        f"integers by {e_fid:.3g} (limit 1e-6), largest {int(fids.max())} (limit 4211), background depth std "
        f"{depth_std:.3g} (limit 1e-6)")
    check(all(v <= 1e-9 for v in errs.values()), "render_deferred: the kernel route disagrees with the plain versions")
    check(mask.any() and e_bary <= 1e-6 and e_fid <= 1e-6 and fids.max() < 4212 and depth_std < 1e-6,
          "render_deferred: a channel contract failed")
    ms = median_step_ms(lambda: scene.render_deferred(camera), device, reps=10)
    say(f"render_deferred at 640x480: median {ms:.4f} ms a render (10 renders)")
    return {"raster_fwd": measured["raster_fwd"]}, launches, ms


def scene2d_of(fields, device, impl):
    """``fields`` (bench_scene_fields) as a float64 Scene2D."""
    from deodr_tpu_torch.scene import Scene2D

    keys = ("faces", "faces_uv", "ij", "depths", "textured", "uv", "shade", "colors", "shaded", "edgeflags",
            "height", "width", "background_color", "clockwise", "backface_culling")
    return Scene2D(**{k: fields[k] for k in keys}, nb_colors=fields["colors"].shape[1], texture=np.zeros((0, 0)),
                   device=device, impl=impl)


def run_scene2d_tiled(device, say):
    """Phase 8d; returns (measurements, launches, median step ms per mode)."""
    from deodr_tpu_torch.bench_scene import bench_scene_fields
    from deodr_tpu_torch.ops import kernels

    fields = bench_scene_fields(512, 512, n_tri=512)
    scene, reference = scene2d_of(fields, device, "kernel"), scene2d_of(fields, device, "reference")
    tiling, cap = scene._plan_tiling(1.0), scene._aa_capacity(1.0)
    say(f"Scene2D tiled ({scene.faces.shape[0]} untextured triangles, 512x512, float64, every edge flagged, "
        f"sigma=1): plan {tiling}, aa_edge_capacity={cap}")
    check(tiling is not None, "Scene2D above 256 faces: no tiling")
    obs = np.random.RandomState(3).rand(512, 512, 3)
    launches, ms = {}, {}
    for error_mode in (False, True):
        tag = f"Scene2D tiled {'error' if error_mode else 'image'} mode"
        kernels.reset_launches()
        got = scene.render_compare_and_backward(obs, 1.0, antialiase_error=error_mode)
        launched = dict(kernels.LAUNCHES)
        want = reference.render_compare_and_backward(obs, 1.0, antialiase_error=error_mode)
        fin = np.isfinite(want[1])
        check(np.array_equal(fin, np.isfinite(got[1])), f"{tag}: coverage differs from the plain versions")
        errs = {"image": np.abs(got[0] - want[0]).max(), "z": np.abs(got[1] - want[1])[fin].max(),
                "err": np.abs(got[2] - want[2]).max() / max(1.0, np.abs(want[2]).max()),
                "ij_b": np.abs(scene.ij_b - reference.ij_b).max() / max(1.0, np.abs(reference.ij_b).max()),
                "colors_b": np.abs(scene.colors_b - reference.colors_b).max() / max(1.0, np.abs(reference.colors_b).max())}
        say(f"{tag} against impl='reference': loss {got[3]!r} vs {want[3]!r}; err (of scale for err and the "
            "gradients; limit 1e-9): " + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
            + f"; launches {launched}")
        check(all(v <= 1e-9 for v in errs.values()), f"{tag}: the kernels disagree with the plain versions")
        check(float(np.abs(scene.ij_b).max()) > 0 and float(np.abs(scene.colors_b).max()) > 0,
              f"{tag}: an all-zero gradient")
        for name in UNTEXTURED_KERNELS:
            check(device.type != "cuda" or launched[name] == 1, f"{tag}: {name} launched {launched[name]} times")
        check(not any(v for k, v in launched.items() if k not in UNTEXTURED_KERNELS), f"{tag}: other kernels launched")
        if not error_mode:
            launches = launched

        def step(error_mode=error_mode):
            scene.render_compare_and_backward(obs, 1.0, antialiase_error=error_mode)

        ms[tag] = median_step_ms(step, device, reps=10)
        say(f"{tag} step (render_compare_and_backward, host reads included): median {ms[tag]:.4f} ms (10 steps)")
        if not error_mode:
            profile_step(step, tag, device, say, steps=3)
    with torch.no_grad():
        buffers = scene._buffers(*scene._diff_inputs())
    obs_t = torch.from_numpy(obs).to(device)
    return check_kernels(buffers, tiling, obs_t, device, say, edge_cap=cap), launches, ms


def run_scenes(device, say):
    """Phase 8; returns (measurements, launches, ms) per path."""
    t0 = time.perf_counter()
    proc, cpu_refs = start_cpu_references()
    try:
        ms = {"soup": run_soup(device, say, cpu_refs), "texture_fits": run_texture_fits(device, say, cpu_refs)}
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.wait()
    measured, launches = {}, {}
    measured["deferred_duck"], launches["deferred_duck"], ms["deferred_duck"] = run_duck_examples(device, say)
    measured["scene2d"], launches["scene2d"], ms["scene2d"] = run_scene2d_tiled(device, say)
    say(f"phase 8 (the scenes) took {time.perf_counter() - t0:.1f} s")
    return measured, launches, ms



# ------------------------------------------------------------ large meshes


# The large-mesh configurations of tools/size_sweep.py::run_config at full size: octahedron_mesh(level) (8192,
# 32768, 131072 faces) seen by default_camera(res, res, 60, vertices, diag(1, -1, -1)), the light
# (-0.4, -0.4, -0.8) / 0.4 and the background (0.2, 0.3, 0.5), in float32 (tag, level, resolution, sigma, the
# binner the plan must pick). The port plans the kernel route, as the JAX planner does with impl="pallas": there
# octahedron_mesh(5) gets supertiles at 2048² (at 640x512 both keep dense binning; the JAX test that asserts
# supertiles at 640x512 plans its XLA route)
LARGE_SCENES = (
    ("octahedron5_2048_s0", 5, 2048, 0.0, "supertiles"),
    ("octahedron6_1024_s1", 6, 1024, 1.0, "pairs"),
    ("octahedron7_2048_s1", 7, 2048, 1.0, "pairs"),
    ("octahedron7_2048_s0", 7, 2048, 0.0, "pairs"),
)
# the scene whose tables give the large_mesh path's kernel records, and the one checked in float64 against the
# plain versions
LARGE_KERNEL_SCENE = "octahedron7_2048_s1"
# a large-mesh binner against dense binning at the same capacities, on the same buffers: the same slot lists make
# the same tables, so image and z are expected bit-equal (the limit is float32's rounding). The gradients sum with
# float atomics (B1b's block sums, index_select's backward) in an order that changes from run to run, and the
# gradient to ij takes differences of sums of g·x at pixel coordinates up to 2047: in float32 two runs of the same
# dense plan differ by up to 1.8e-3 of scale (octahedron_mesh(5) at 2048², an NVIDIA H100 80GB HBM3). So the exact
# comparison is made in float64 (1e-9 of scale), and float32 gradients are held within LARGE_LIMIT_GRAD32 of scale,
# beside the spread of two dense runs
LARGE_LIMIT_OUT, LARGE_LIMIT_GRAD32, LARGE_LIMIT64 = 1e-6, 1e-2, 1e-9
LIGHT_LARGE, BACKGROUND_LARGE = (-0.4, -0.4, -0.8), (0.2, 0.3, 0.5)


def large_scene(level, res, sigma, device, dtype, impl="kernel"):
    """(Scene3D, camera) of size_sweep's configuration, the mesh's tensors
    in ``dtype`` on ``device``."""
    from deodr_tpu_torch import Scene3D, default_camera
    from deodr_tpu_torch.geometry.primitives import octahedron_mesh

    mesh = octahedron_mesh(level)
    camera = default_camera(res, res, 60, mesh.vertices.numpy(), np.diag([1.0, -1.0, -1.0]))
    mesh.set_vertices(mesh.vertices.to(device, dtype))
    mesh.set_vertices_colors(mesh.vertices_colors.to(device, dtype))
    scene = Scene3D(sigma=sigma, device=device, impl=impl)
    scene.set_mesh(mesh)
    scene.set_light(np.array(LIGHT_LARGE), 0.4)
    scene.set_background_color(np.array(BACKGROUND_LARGE))
    return scene, camera


def large_buffers(scene, camera):
    """The SceneBuffers of the scene's view, with no autograd graph."""
    with torch.no_grad():
        return scene._build_buffers(camera, *scene._diff_inputs(False), True, None)[0]


def large_loss_grads(buffers, sigma, plan, obs, impl="kernel", check_capacity=False):
    """Image ("out"), z and the gradients to ij and colors of size_sweep's
    loss Σ (render − obs)² on ``buffers`` with the Scene3D ``plan``, as
    check_against takes them."""
    from deodr_tpu_torch import render_scene

    cap, tiling, aa_window, aa_tex_window, aa_tex_plan = plan
    ij = buffers.ij.detach().clone().requires_grad_(True)
    colors = buffers.colors.detach().clone().requires_grad_(True)
    image, z, _ = render_scene(dataclasses.replace(buffers, ij=ij, colors=colors), float(sigma), aa_edge_capacity=cap,
                               tiling=tiling, impl=impl, aa_window=aa_window, aa_tex_window=aa_tex_window,
                               aa_tex_plan=aa_tex_plan, check_capacity=check_capacity)
    g_ij, g_c = torch.autograd.grad(((image - obs) ** 2).sum(), (ij, colors))
    return dict(out=image.detach(), z=z, ij=g_ij, colors=g_c)


def dense_plan(plan):
    """A Scene3D plan with its large-mesh binning fields zeroed: dense
    binning at the same capacities."""
    return (plan[0], plan[1]._replace(super_ty=0, super_tx=0, super_capacity=0, pair_ry=0, pair_rx=0)) + plan[2:]


def binning_fns(buffers, tiling):
    """The solid pass's binning of ``buffers`` alone (as raster_tables
    bins, after the drawn-triangle compaction), with ``tiling``'s binner and
    with dense binning at the same capacities → (binner, dense) functions."""
    from deodr_tpu_torch.ops.raster import triangle_row_setup
    from deodr_tpu_torch.ops.render import prepare
    from deodr_tpu_torch.ops.tiled import _bin_boxes, _compact_index_perm, _grid

    with torch.no_grad():
        ij_off, _, draw, _ = prepare(buffers)
        faces = buffers.faces
        if tiling.drawn_capacity:
            perm, got = _compact_index_perm(draw, min(tiling.drawn_capacity, faces.shape[0]))
            faces, draw = faces[perm], draw[perm] & got
        setup = triangle_row_setup(ij_off[faces], buffers.depths[faces], draw, buffers.width, buffers.height,
                                   buffers.strict_edge, buffers.perspective_correct)
    grid = _grid(buffers.height, buffers.width, tiling.tile_h, tiling.tile_w)
    dense = dense_plan((None, tiling))[1]

    def binning(t):
        def fn():
            with torch.no_grad():
                return _bin_boxes(t, setup.x_lo, setup.x_hi, setup.y_lo[:, 0], setup.y_hi[:, 1], setup.valid, grid,
                                  t.triangle_capacity)
        return fn

    return binning(tiling), binning(dense)


def run_b1b_split(device, say):
    """Phase 9e: B1b where one launch's table does not fit a block's
    shared memory (ROADMAP C.1): the exploded duck of
    render_mesh.example_channels at 320x240 (float64, D = 14, triangle
    capacity 1024) differentiated through render_scene against
    impl="reference", and a slot-window case (float64, D = 1, capacity
    16384) on a synthetic table against the plain version."""
    from deodr_tpu_torch import data_path, render_scene
    from deodr_tpu_torch.examples import render_mesh
    from deodr_tpu_torch.ops import kernels
    from deodr_tpu_torch.ops.kernels import TileGrid
    from deodr_tpu_torch.ops.kernels import raster_kernel as rk

    scene, camera = render_mesh.default_scene(os.path.join(data_path, "duck.obj"), 320, 240, device=device)
    scene.sigma = 0
    buffers, tiling, _ = scene._deferred_buffers(camera)
    d, cap = buffers.colors.shape[1], tiling.triangle_capacity
    batches = rk.raster_bwd_batches(cap, d, buffers.colors.element_size())
    say(f"B1b split: the exploded duck at 320x240, {buffers.colors.dtype}, D = {d}, triangle capacity {cap}: "
        f"{len(batches)} launches {[tuple(b) for b in batches]}")
    check(d == 14 and cap == 1024 and buffers.colors.dtype == torch.float64 and len(batches) > 1,
          "B1b split: the duck's deferred buffers are not a table that needs a split")
    weight = torch.from_numpy(np.random.RandomState(12).rand(240, 320, d)).to(device)

    def grads(impl):
        ij = buffers.ij.detach().clone().requires_grad_(True)
        colors = buffers.colors.detach().clone().requires_grad_(True)
        image, _, _ = render_scene(dataclasses.replace(buffers, ij=ij, colors=colors), 0.0, tiling=tiling, impl=impl,
                                   check_capacity=True)
        return (image.detach(),) + torch.autograd.grad((image * weight).sum(), (ij, colors))

    kernels.reset_launches()
    got = grads("kernel")
    n = kernels.LAUNCHES["raster_bwd"]
    want = grads("reference")
    errs = [rel_err(a, b) for a, b in zip(got, want)]
    say(f"B1b split: render_scene fwd+bwd on the kernels against impl='reference': image {errs[0]:.3g}, grad ij "
        f"{errs[1]:.3g}, grad colors {errs[2]:.3g} of scale (limit 1e-9); raster_bwd launched {n} times "
        f"(predicted {len(batches)})")
    check(max(errs) <= 1e-9, "B1b split: the kernels disagree with the plain versions")
    check(device.type != "cuda" or n == len(batches), "B1b split: not one launch a batch")

    # slot windows: one plane at capacity 16384 does not fit in float64 either
    grid = TileGrid(2, 2, 16, 128)
    hp, wp = grid.padded_hw
    rng = np.random.RandomState(13)
    cap = 16384
    slot_map = torch.from_numpy(rng.randint(0, cap + 1, (hp, wp)).astype(np.int32)).to(device)
    counts = torch.tensor([cap, 12000, 9000, 0], dtype=torch.int32, device=device)
    g_vals = torch.from_numpy(rng.randn(1, hp, wp)).to(device)
    batches = rk.raster_bwd_batches(cap, 1, 8)
    kernels.reset_launches()
    got = rk.raster_bwd(slot_map, g_vals, counts, grid, cap)
    n = kernels.LAUNCHES["raster_bwd"]
    want = rk.raster_bwd(slot_map, g_vals, counts, grid, cap, impl="reference")
    e = rel_err(got, want)
    say(f"B1b slot windows: float64, D = 1, capacity {cap}, {[tuple(b) for b in batches]}: g_table err {e:.3g} of "
        f"scale (limit 1e-9); raster_bwd launched {n} times")
    check(e <= 1e-9, "B1b slot windows: the kernel disagrees with the plain version")
    check(device.type != "cuda" or n == len(batches), "B1b slot windows: not one launch a window")


def run_large_meshes(device, say, scenes=LARGE_SCENES, kernel_scene=LARGE_KERNEL_SCENE):
    """Phase 9 on ``scenes`` (smaller ones serve a rehearsal on the CPU);
    returns (measurements, launches, step ms) of the large_mesh path (the
    kernel records of ``kernel_scene``)."""
    from deodr_tpu_torch.ops import kernels
    from deodr_tpu_torch.ops.kernels import raster_kernel as rk
    from deodr_tpu_torch.ops.render import prepare
    from deodr_tpu_torch.ops.tiled import raster_tables

    t0 = time.perf_counter()
    ms, fns, measured, launches = {}, {}, None, None
    for tag, level, res, sigma, binner in scenes:
        scene, camera = large_scene(level, res, sigma, device, torch.float32)
        plan = scene._eager_plan(camera)
        cap, tiling = plan[0], plan[1]
        say(f"{tag}: {scene.mesh.nb_faces} faces at {res}x{res}, sigma={sigma:g}, float32: aa_edge_capacity={cap}, "
            f"{tiling}")
        picked = tiling is not None and (tiling.super_capacity > 0 and tiling.pair_ry * tiling.pair_rx == 0
                                         if binner == "supertiles" else tiling.pair_ry * tiling.pair_rx > 0)
        check(picked, f"{tag}: the planner did not pick {binner}")
        buffers = large_buffers(scene, camera)
        with torch.no_grad():
            ij_off, _, draw, _ = prepare(buffers)
            rt = raster_tables(buffers, ij_off, draw, tiling)
            obs = (scene.render(camera) + 0.05).clamp(0.0, 1.0)
        n_b1b = len(rk.raster_bwd_batches(rt.setup_tile.shape[1], rt.affine_tile.shape[2] // 3,
                                          rt.affine_tile.element_size()))
        say(f"{tag}: {rt.grid.n_tiles} tiles of {rt.grid.tile_h}x{rt.grid.tile_w}, slot capacity "
            f"{rt.setup_tile.shape[1]}, fullest tile {int(rt.counts.max())}, {int(draw.sum())} drawn faces")

        # the main path: Scene3D render + render_backward, every bin checked, launches counted
        kernels.reset_launches()
        image, _ = scene.render(camera, return_z_buffer=True, check_capacity=True)
        scene.render_backward(2 * (image - obs))
        got = dict(kernels.LAUNCHES)
        want = dict.fromkeys(kernels.KERNEL_NAMES, 0)
        want.update(raster_fwd=1, raster_bwd=n_b1b, edge_fwd=int(sigma > 0), edge_bwd=int(sigma > 0))
        say(f"launches on {tag} (one render and its backward): {got} (expected {want})")
        check(device.type != "cuda" or got == want, f"{tag}: launches differ from one render's")
        grads = (scene.mesh._vertices_b, scene.mesh.vertices_colors_b)
        check(all(bool(torch.isfinite(g).all()) for g in grads) and float(grads[0].abs().max()) > 0,
              f"{tag}: Scene3D's gradients are not finite or all zero")

        # the binner against dense binning at the same capacities, on the same buffers, in float32 (with the spread
        # of two dense runs) and in float64; at kernel_scene the float64 kernels against their plain versions
        want = large_loss_grads(buffers, sigma, dense_plan(plan), obs)
        check_against(f"{tag}: dense binning run twice", large_loss_grads(buffers, sigma, dense_plan(plan), obs),
                      want, say, LARGE_LIMIT_OUT, LARGE_LIMIT_OUT, LARGE_LIMIT_GRAD32)
        check_against(f"{tag}: {binner} against dense binning", large_loss_grads(buffers, sigma, plan, obs), want,
                      say, LARGE_LIMIT_OUT, LARGE_LIMIT_OUT, LARGE_LIMIT_GRAD32)
        scene64, _ = large_scene(level, res, sigma, device, torch.float64)
        plan64 = scene64._eager_plan(camera)
        buffers64, obs64 = large_buffers(scene64, camera), obs.to(torch.float64)
        got64 = large_loss_grads(buffers64, sigma, plan64, obs64, check_capacity=True)
        check_against(f"{tag} float64: {binner} against dense binning", got64,
                      large_loss_grads(buffers64, sigma, dense_plan(plan64), obs64), say, *(LARGE_LIMIT64,) * 3)
        if tag == kernel_scene:
            check_against(f"{tag} float64: kernels against impl='reference'", got64,
                          large_loss_grads(buffers64, sigma, plan64, obs64, impl="reference"), say,
                          *(LARGE_LIMIT64,) * 3)

        def step(scene=scene, camera=camera, obs=obs):
            scene.render_backward(2 * (scene.render(camera) - obs))

        ms[tag] = median_step_ms(step, device, reps=10)
        say(f"{tag} step (Scene3D render + render_backward): median {ms[tag]:.4f} ms, "
            f"{res * res / (ms[tag] * 1e-3) / 1e6:.2f} Mpix/s (10 steps)")
        profile_step(step, tag, device, say, steps=3)
        fns[(tag, binner)], fns[(tag, "dense")] = ((fn, None) for fn in binning_fns(buffers, tiling))
        if tag == kernel_scene:
            measured = check_kernels(buffers, tiling, obs, device, say, edge_cap=cap)
            launches = got
    for (tag, binner), (t, n_ops) in device_times(fns, device).items():
        say(f"{tag}: binning by {binner}, device time "
            + ("not measured (no card)" if t is None else f"{t:.4f} ms in {n_ops:g} device operations"))
    run_b1b_split(device, say)
    say(f"phase 9 (large meshes) took {time.perf_counter() - t0:.1f} s")
    return measured, launches, ms


# ------------------------------------------------------ scale-out and auxiliaries (phase 10)

# two ranks share the one card over gloo (NCCL refuses two ranks on one card); NCCL runs at world size 1
SCALE_WORLD = 2
# the duck's textured multi-view step: views (ij perturbed by 0.1 px, seed 7), float64, and its learning rate
MULTIVIEW_VIEWS, MULTIVIEW_LR = 4, 1e-3
# the view-sharded multi-frame fitter: octahedron_mesh(FIT_LEVEL) (512 faces: the tiled route, B1 and B2)
FIT_FRAMES, FIT_STEPS, FIT_LEVEL, FIT_H, FIT_W = 4, 3, 3, 96, 128
ADAM_ITERS, ADAM_BAR = 30, 0.85
BATCH = 4
VIEWER_W, VIEWER_H, VIEWER_FPS_FRAMES = 320, 240, 20
# the viewer's 10 frames: the action before each (a key, or a camera move)
VIEWER_ACTIONS = ("start", "rotate", "zoom", "l", "l", "p", "p", "a", "r", "r")
SHARDED_STEPS = 10


def sharded_bench_step(mesh, scene, tiling, obs):
    """One fwd+bwd of the bench loss through the tile-sharded render →
    dict(out, z, ij, colors) (the image, its z-buffer and the gradients)."""
    from deodr_tpu_torch.parallel import make_tile_sharded_render

    render = make_tile_sharded_render(scene, 1.0, mesh, aa_edge_capacity=AA_EDGE_CAPACITY, tiling=tiling)

    def step():
        ij = scene.ij.detach().clone().requires_grad_(True)
        colors = scene.colors.detach().clone().requires_grad_(True)
        image, z = render(dataclasses.replace(scene, ij=ij, colors=colors))
        ((image - obs) ** 2).sum().backward()
        return dict(out=image.detach(), z=z, ij=ij.grad, colors=colors.grad)

    return step


def single_bench(scene, tiling, obs):
    out, _, g_ij, g_c, z = loss_and_grads(scene, 1.0, tiling, obs, False, "kernel", check_capacity=False,
                                          with_z=True)
    return dict(out=out, z=z, ij=g_ij, colors=g_c)


def banded_bench(scene, tiling, obs, n_bands):
    """The tile-sharded bench step's arithmetic in one process: each band
    rendered with its rows' translation, the bands stitched, one backward →
    dict(out, z, ij, colors)."""
    from deodr_tpu_torch import render_scene

    ij = scene.ij.detach().clone().requires_grad_(True)
    colors = scene.colors.detach().clone().requires_grad_(True)
    band_h = -(-scene.height // n_bands)
    bands = [render_scene(dataclasses.replace(scene, ij=ij - ij.new_tensor([0.0, d * band_h]), colors=colors,
                                              height=band_h), 1.0, aa_edge_capacity=AA_EDGE_CAPACITY, tiling=tiling)
             for d in range(n_bands)]
    image = torch.cat([b[0] for b in bands])[:scene.height]
    ((image - obs) ** 2).sum().backward()
    return dict(out=image.detach(), z=torch.cat([b[1] for b in bands])[:scene.height], ij=ij.grad, colors=colors.grad)


def bench64(fields, device):
    from deodr_tpu_torch import scene_buffers_from_numpy

    obs = torch.from_numpy(np.random.RandomState(3).rand(fields["height"], fields["width"], 3)).to(device)
    return scene_buffers_from_numpy(fields, device=device, dtype=torch.float64), obs


def duck_views(device):
    """The duck in float64, its observation, and MULTIVIEW_VIEWS views'
    ij (the duck's, perturbed by 0.1 px) and observations."""
    from deodr_tpu_torch import duck_scene as ds
    from deodr_tpu_torch import render_scene, scene_buffers_from_numpy

    fields = ds.duck_scene_fields()
    scene = scene_buffers_from_numpy(fields, device=device, dtype=torch.float64)
    with torch.no_grad():
        image, _, _ = render_scene(scene, ds.DUCK_SIGMA, aa_edge_capacity=ds.DUCK_AA_EDGE_CAPACITY,
                                   tiling=ds.DUCK_TILING, aa_tex_plan=ds.DUCK_TEX_PLAN)
    obs = (image + 0.05).clamp(0.0, 1.0)
    rng = np.random.RandomState(7)
    ij = torch.from_numpy(fields["ij"][None] + rng.randn(MULTIVIEW_VIEWS, *fields["ij"].shape) * 0.1).to(device)
    return scene, obs, ij, obs[None].expand(MULTIVIEW_VIEWS, -1, -1, -1).contiguous()


def fitter_of(device, dtype=torch.float64):
    """The multi-frame fitter of tests/test_parallel.py on octahedron_mesh(FIT_LEVEL)."""
    from deodr_tpu_torch import MeshRGBFitterWithPoseMultiFrame
    from deodr_tpu_torch.geometry.primitives import octahedron_mesh

    base = octahedron_mesh(FIT_LEVEL)
    rng = np.random.RandomState(0)
    f = MeshRGBFitterWithPoseMultiFrame(
        vertices=base.vertices.numpy(), faces=base.faces, euler_init=np.zeros((FIT_FRAMES, 3)),
        translation_init=np.zeros((FIT_FRAMES, 3)), default_color=np.array([0.4, 0.3, 0.25]),
        default_light_directional=np.array([0.1, 0.5, 0.4]), default_light_ambient=0.6, device=device, dtype=dtype)
    f.set_background_color(np.array([0.1, 0.2, 0.3]))
    f.set_images([np.clip(0.5 + 0.2 * rng.rand(FIT_H, FIT_W, 3), 0, 1) for _ in range(FIT_FRAMES)])
    return f


def run_fitter(f):
    """FIT_STEPS steps → (energies, the state's arrays by name)."""
    with contextlib.redirect_stdout(io.StringIO()):
        energies = [f.step()[0] for _ in range(FIT_STEPS)]
    return energies, dict(vertices=f.vertices, quaternion=f.transform_quaternion, mesh_color=f.mesh_color,
                          light_directional=f.light_directional)


def host(d):
    return {k: v.detach().cpu() if isinstance(v, torch.Tensor) else v for k, v in d.items()}


def scale_out_rank(rank, world, device_type="cuda"):
    """Phase 10's distributed work in one rank of a ("views", "tiles") mesh
    on the card: the bench's tile-sharded fwd+bwd in float64 and float32
    (and the float32 step's median over SHARDED_STEPS), the duck's textured
    multi-view step and the view-sharded fitter, each with its launches
    and collectives → results on the host."""
    from deodr_tpu_torch import duck_scene as ds
    from deodr_tpu_torch.ops import kernels
    from deodr_tpu_torch.parallel import make_device_mesh, make_textured_multiview_step, sharding

    device = torch.device(device_type)
    out = {}
    tiles = make_device_mesh(1, world, device_type)
    fields, scene, tiling, obs = bench_setup(device)
    scene64, obs64 = bench64(fields, device)
    for tag, s, o in (("bench64", scene64, obs64), ("bench32", scene, obs)):
        step = sharded_bench_step(tiles, s, tiling, o)
        kernels.reset_launches()
        sharding.reset_collectives()
        out[tag] = host(step())
        out[tag]["launches"] = dict(kernels.LAUNCHES)
        out[tag]["collectives"] = [tuple(c) for c in sharding.COLLECTIVES]
    out["bench32"]["ms"] = median_step_ms(step, device, reps=SHARDED_STEPS)

    views = make_device_mesh(world, 1, device_type)
    scene_d, _, ij, obs_d = duck_views(device)
    params = {k: getattr(scene_d, k) for k in ("texture", "uv", "shade")}
    step = make_textured_multiview_step(scene_d, ds.DUCK_SIGMA, views, lr=MULTIVIEW_LR,
                                        aa_edge_capacity=ds.DUCK_AA_EDGE_CAPACITY, tiling=ds.DUCK_TILING,
                                        aa_tex_plan=ds.DUCK_TEX_PLAN)
    kernels.reset_launches()
    sharding.reset_collectives()
    new, loss = step(params, ij, obs_d)
    out["duck"] = dict(params=host(new), loss=float(loss), launches=dict(kernels.LAUNCHES),
                       collectives=[tuple(c) for c in sharding.COLLECTIVES])

    f = fitter_of(device)
    f.set_device_mesh(views)
    kernels.reset_launches()
    sharding.reset_collectives()
    energies, state = run_fitter(f)
    out["fitter"] = dict(energies=energies, state=state, launches=dict(kernels.LAUNCHES),
                         collectives=[tuple(c) for c in sharding.COLLECTIVES])
    return out


def check_launches(tag, launches, names, device, say, n=None):
    """Each kernel of ``names`` launched (exactly ``n`` times where given);
    checked where the kernels run, on the card."""
    say(f"launches on {tag}: " + ", ".join(f"{k} {launches[k]}" for k in names))
    for k in names:
        check(device.type != "cuda" or (launches[k] > 0 if n is None else launches[k] == n),
              f"{tag}: {k} launched {launches[k]} times")


def run_tile_sharded(device, say):
    """Phase 10a: the bench's tile-sharded fwd+bwd at world size 1 (NCCL,
    in this process) and SCALE_WORLD (gloo, spawned ranks on this card),
    against the single-process render; the other distributed paths (10b,
    10c) run in the same ranks → (rank results, kernels measured on a band)."""
    from deodr_tpu_torch.ops import kernels
    from deodr_tpu_torch.parallel import init_process_group, make_device_mesh, run_ranks, sharding

    fields, scene, tiling, obs = bench_setup(device)
    scene64, obs64 = bench64(fields, device)
    want64 = single_bench(scene64, tiling, obs64)

    # world size 1 on NCCL: the band is the frame, so the render is the single-process one
    backend = "nccl" if device.type == "cuda" else "gloo"
    with tempfile.TemporaryDirectory() as tmp:
        init_process_group(0, 1, "file://" + os.path.join(tmp, "rendezvous"), backend)
        try:
            kernels.reset_launches()
            sharding.reset_collectives()
            got = sharded_bench_step(make_device_mesh(1, 1, device.type), scene64, tiling, obs64)()
            check_launches(f"tile-sharded bench, world size 1 ({backend})", kernels.LAUNCHES, UNTEXTURED_KERNELS,
                           device, say)
            say(f"tile-sharded bench, world size 1 ({backend}): collectives {[c[:2] for c in sharding.COLLECTIVES]}")
        finally:
            torch.distributed.destroy_process_group()
    check(torch.equal(got["out"], want64["out"]) and torch.equal(got["z"], want64["z"]),
          "tile-sharded bench at world size 1: the image or z differs from render_scene's")
    check_against(f"tile-sharded bench float64, world size 1 ({backend}), image and z bit-equal", got, want64, say,
                  0.0, 0.0, 1e-12)

    t0 = time.perf_counter()
    ranks = run_ranks(scale_out_rank, SCALE_WORLD, (device.type,), backend="gloo", device=device.type,
                      threads=None if device.type == "cuda" else 1)
    say(f"{SCALE_WORLD} ranks (gloo, one card) ran the bench, the duck's multi-view step and the fitter in "
        f"{time.perf_counter() - t0:.1f} s")
    band_h = -(-fields["height"] // SCALE_WORLD)
    # float32: a band's translation rounds the triangles' setup differently, and pixels within an ulp of an edge
    # may change sides; the sharded step is held to the same bands rendered in one process (bit-equal image and
    # z, gradients beside the spread of two such runs), and its coverage against the unsharded render is counted
    want32 = [banded_bench(scene, tiling, obs, SCALE_WORLD) for _ in range(2)]
    check_against("bench float32, its bands rendered in one process, run twice (the spread: float atomics)",
                  want32[1], want32[0], say, 0.0, 0.0, LARGE_LIMIT_GRAD32)
    single32 = single_bench(scene, tiling, obs)["z"].cpu()
    frame32 = fields["height"] * fields["width"] * 3 * 4
    for rank, r in enumerate(ranks):
        tag = f"tile-sharded bench, world size {SCALE_WORLD} (gloo), rank {rank}"
        check_against(f"{tag}, float64", r["bench64"], host(want64), say, *(LARGE_LIMIT64,) * 3)
        check_against(f"{tag}, float32, against its bands in one process", r["bench32"], host(want32[0]), say,
                      0.0, 0.0, LARGE_LIMIT_GRAD32)
        flips = int((torch.isfinite(r["bench32"]["z"]) != torch.isfinite(single32)).sum())
        say(f"{tag}, float32: {flips} pixels covered differently from the unsharded render (limit "
            f"{MAX_BOUNDARY_SHARE:g} of {fields['height'] * fields['width']})")
        check(flips <= MAX_BOUNDARY_SHARE * fields["height"] * fields["width"], f"{tag}: coverage differs too often")
        for dt in ("bench64", "bench32"):
            check_launches(f"{tag} ({dt})", r[dt]["launches"], UNTEXTURED_KERNELS, device, say)
            col = r[dt]["collectives"]
            say(f"{tag} ({dt}) collectives: " + "; ".join(f"{c[0]} {c[1]} B{' (backward)' if c[3] else ''}"
                                                           for c in col))
            n_grad = fields["ij"].size + fields["colors"].size
            itemsize = 8 if dt == "bench64" else 4
            check([c[0] for c in col] == ["all_gather", "all_reduce"] and col[1][3]
                  and col[0][1] == band_h * fields["width"] * 4 * itemsize and col[1][1] == n_grad * itemsize
                  and col[1][1] < frame32, f"{tag} ({dt}): unexpected collectives {col}")
    ms_single = median_step_ms(lambda: single_bench(scene, tiling, obs), device, reps=SHARDED_STEPS)
    say(f"bench fwd+bwd step sigma=1, float32: single process median {ms_single:.4f} ms; tile-sharded over "
        f"{SCALE_WORLD} gloo ranks on one card median {ranks[0]['bench32']['ms']:.4f} ms (rank 0; both ranks share "
        "the card and the band exchange is staged through host memory: not a multi-GPU speed)")

    # the kernels at the band's shapes (rank 0's band), against their plain versions
    band = dataclasses.replace(scene, height=band_h)
    measured = check_kernels(band, tiling, obs[:band_h], device, say)
    return ranks, measured, dict(single=ms_single, sharded=ranks[0]["bench32"]["ms"])


def run_multiview_duck(ranks, device, say):
    """Phase 10b: the duck's textured multi-view step (float64) over
    SCALE_WORLD ranks against the sequential sum of its views' losses and
    gradients; exactly texture + uv + shade + loss all-reduced; B1 and B3
    launched in each rank → kernels measured at the float64 duck's shapes."""
    names = ("texture", "uv", "shade")
    scene, obs, ij, obs_v = duck_views(device)
    loss, grads = 0.0, {k: 0.0 for k in names}
    for v in range(MULTIVIEW_VIEWS):
        _, _, l_v, g_v = duck_loss_and_grads(dataclasses.replace(scene, ij=ij[v]), obs_v[v], "kernel")
        loss += float(l_v)
        grads = {k: grads[k] + g_v[k] for k in names}
    n_bytes = (sum(getattr(scene, k).numel() for k in names) + 1) * 8
    for rank, r in enumerate(ranks):
        tag = f"duck multi-view step, {MULTIVIEW_VIEWS} views over {SCALE_WORLD} ranks, rank {rank}"
        d = r["duck"]
        errs = {k: rel_err((getattr(scene, k).cpu() - d["params"][k]) / MULTIVIEW_LR, grads[k].cpu()) for k in names}
        e_loss = abs(d["loss"] - loss) / abs(loss)
        say(f"{tag}: loss {d['loss']:.6f} vs sequential {loss:.6f} (rel {e_loss:.3g}, limit 1e-9); update err of "
            f"scale (limit 1e-9): " + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()))
        check(e_loss <= 1e-9 and all(v <= 1e-9 for v in errs.values()), f"{tag}: differs from the sequential sum")
        check_launches(tag, d["launches"], ("raster_fwd", "raster_bwd", "edge_tex_fwd", "edge_tex_bwd"), device, say,
                       MULTIVIEW_VIEWS // SCALE_WORLD)
        col = d["collectives"]
        say(f"{tag}: collectives {[c[:2] for c in col]}; texture + uv + shade + loss = {n_bytes} B")
        check([c[:2] for c in col] == [("all_reduce", n_bytes)], f"{tag}: the step's collectives are not one "
                                                                   f"all-reduce of texture + uv + shade + loss")
    return check_tex_kernels(scene, obs, device, say)


def run_sharded_fitter(ranks, device, say):
    """Phase 10c: the view-sharded multi-frame fitter against the sequential
    one (float64, tests/test_parallel.py's tolerances)."""
    energies, state = run_fitter(fitter_of(device))
    for rank, r in enumerate(ranks):
        tag = f"multi-frame fitter, {FIT_FRAMES} frames of octahedron_mesh({FIT_LEVEL}) over {SCALE_WORLD} ranks, rank {rank}"
        f = r["fitter"]
        e_rel = max(abs(a - b) / abs(b) for a, b in zip(f["energies"], energies))
        errs = {k: float(np.abs(f["state"][k] - state[k]).max()) for k in state}
        say(f"{tag}: energies {' '.join(f'{e:.6f}' for e in f['energies'])} (rel {e_rel:.3g} of the sequential "
            f"fit's, limit 1e-9); state err (vertices 1e-10, others 1e-12): "
            + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()))
        check(e_rel <= 1e-9 and errs["vertices"] <= 1e-10
              and all(v <= 1e-12 for k, v in errs.items() if k != "vertices"),
              f"{tag}: differs from the sequential fitter")
        check_launches(tag, f["launches"], UNTEXTURED_KERNELS, device, say)
        check([c[0] for c in f["collectives"]] == ["all_gather", "all_reduce"] * FIT_STEPS,
              f"{tag}: unexpected collectives {f['collectives']}")


def run_adam(device, say):
    """Phase 10d: the Adam depth fit, ADAM_ITERS iterations → ms per iteration."""
    from deodr_tpu_torch.examples import optax_fitting

    t0 = time.perf_counter()
    energies = optax_fitting.run(max_iter=ADAM_ITERS, device=device)
    ms = (time.perf_counter() - t0) * 1e3 / ADAM_ITERS
    say(f"Adam depth fit: energy {energies[0]:.4f} -> {energies[-1]:.4f} in {ADAM_ITERS} iterations (last below "
        f"{ADAM_BAR} x the first), {ms:.4f} ms per iteration (host clock, set-up included)")
    check(all(np.isfinite(energies)) and energies[-1] < ADAM_BAR * energies[0], "the Adam depth fit did not converge")
    return ms


def run_batch(device, say):
    """Phase 10e: a batch of BATCH bench scenes (ij perturbed) through
    render_scene_batch against BATCH single renders → ms per scene, batched
    and single."""
    from deodr_tpu_torch.ops import kernels
    from deodr_tpu_torch.ops.render import render_scene_batch

    _, scene, tiling, obs = bench_setup(device)
    rng = np.random.RandomState(5)
    ij = scene.ij[None] + torch.from_numpy(rng.randn(BATCH, *scene.ij.shape).astype(np.float32) * 0.5).to(device)

    def batched():
        leaf = ij.detach().clone().requires_grad_(True)
        colors = scene.colors.detach().clone().requires_grad_(True)
        images, z, _ = render_scene_batch(dataclasses.replace(scene, ij=leaf, colors=colors), 1.0,
                                          aa_edge_capacity=AA_EDGE_CAPACITY, tiling=tiling)
        ((images - obs) ** 2).sum().backward()
        return images.detach(), z, leaf.grad, colors.grad

    def singles():
        return [single_bench(dataclasses.replace(scene, ij=ij[b]), tiling, obs) for b in range(BATCH)]

    kernels.reset_launches()
    images, z, g_ij, g_c = batched()
    check_launches(f"a batch of {BATCH} bench scenes (one batched render and its backward)", kernels.LAUNCHES,
                   UNTEXTURED_KERNELS, device, say, BATCH)
    want = singles()
    check(tuple(images.shape) == (BATCH, scene.height, scene.width, 3), "the batch's images have the wrong shape")
    for b in range(BATCH):
        got = dict(out=images[b], z=z[b], ij=g_ij[b], colors=None)
        check_against(f"batch scene {b} against its single render", {k: v for k, v in got.items() if v is not None},
                      {k: v for k, v in want[b].items() if k != "colors"}, say, LARGE_LIMIT_OUT, LARGE_LIMIT_OUT,
                      LARGE_LIMIT_GRAD32)
    check(rel_err(g_c, sum(w["colors"] for w in want)) <= LARGE_LIMIT_GRAD32, "the batch's colors gradient differs")
    ms = dict(batched=median_step_ms(batched, device, reps=10) / BATCH,
              single=median_step_ms(singles, device, reps=10) / BATCH)
    say(f"batch of {BATCH} bench scenes, fwd+bwd: {ms['batched']:.4f} ms a scene batched, {ms['single']:.4f} ms a "
        f"scene as {BATCH} single renders (median of 10)")
    return ms


def viewer_reference_frame(viewer):
    """The viewer's current view rendered with impl='reference', as a frame."""
    impl = viewer.impl
    viewer.impl = "reference"
    viewer._rebuild_scene()
    image = viewer.scene.render(viewer.interactor.camera()).cpu().numpy()
    viewer.impl = impl
    viewer._rebuild_scene()
    return (np.clip(image, 0, 1) * 255).astype(np.uint8)


def run_viewer(device, say):
    """Phase 10f: the headless viewer on the duck, a frame after each of
    VIEWER_ACTIONS against the same view with impl='reference' (at most one
    level apart), then its frames per second on the kernels → fps."""
    from deodr_tpu_torch.examples.mesh_viewer import Viewer

    viewer = Viewer(width=VIEWER_W, height=VIEWER_H, headless=True, device=device)
    for action in VIEWER_ACTIONS:
        if action == "rotate":
            viewer.interactor.rotate(25, 10)
        elif action == "zoom":
            viewer.interactor.zoom(0.8)
        elif action != "start":
            viewer.process_key(ord(action))
        frame = viewer.render_frame()
        ref = viewer_reference_frame(viewer)
        off = int(np.abs(frame.astype(int) - ref.astype(int)).max())
        say(f"viewer after {action!r} (route {viewer.impl}, sigma {viewer.scene.sigma:g}, lights "
            f"{viewer.use_lights}, perspective {viewer.perspective_correct}): {int((frame != ref).any(axis=2).sum())} "
            f"pixels differ from impl='reference', by at most {off} level(s) (limit 1)")
        check(frame.shape == (VIEWER_H, VIEWER_W, 3) and off <= 1, f"viewer after {action!r}: the frame differs")
    viewer = Viewer(width=VIEWER_W, height=VIEWER_H, headless=True, device=device)
    viewer.render_frame()
    t0 = time.perf_counter()
    for _ in range(VIEWER_FPS_FRAMES):
        viewer.interactor.rotate(3, 0)
        viewer.render_frame()
    fps = VIEWER_FPS_FRAMES / (time.perf_counter() - t0)
    say(f"viewer on the duck at {VIEWER_W}x{VIEWER_H}, kernels, sigma=1: {fps:.2f} frames per second "
        f"({VIEWER_FPS_FRAMES} frames, host clock, the read-back included)")
    return fps


def run_scale_out(device, say):
    """Phase 10; returns (measurements, launches, ms) per path."""
    t0 = time.perf_counter()
    ranks, bench_measured, ms = run_tile_sharded(device, say)
    measured = {"sharded_bench": bench_measured, "multiview_duck": run_multiview_duck(ranks, device, say)}
    launches = {"sharded_bench": ranks[0]["bench32"]["launches"], "multiview_duck": ranks[0]["duck"]["launches"]}
    run_sharded_fitter(ranks, device, say)
    ms = dict(sharded_bench=ms, adam_iteration=run_adam(device, say), batch=run_batch(device, say),
              viewer_fps=run_viewer(device, say))
    say(f"phase 10 (scale-out and auxiliaries) took {time.perf_counter() - t0:.1f} s")
    return measured, launches, ms


# ---------------------------------------------------------- the torch class surface


# Scene3DTorch with the kernels against the same call with impl="reference" (float32): the image, and the gradients
# of their scale (float atomics add in another order)
SURFACE_LIMIT_IMAGE, SURFACE_LIMIT_GRAD = 1e-4, 1e-3
# float64, Scene3DTorch against the port's Scene3D on the same mesh, camera and lights: image and gradients of scale
SURFACE_LIMIT_F64 = 1e-9
# render_scene_torch against render_scene on the same plan (float64): one function, so the image is bit-equal; the
# backward kernels add with float atomics, whose order changes the gradients' last bits from run to run
BRIDGE_LIMIT_GRAD = 1e-12
SURFACE_ADAM_STEPS = 20


def surface_duck(device, dtype):
    """The duck for ``Scene3DTorch`` (phase 5's mesh, camera, light and
    background) → (mesh, camera, inputs by name on ``device`` in ``dtype``,
    background colour)."""
    from deodr_tpu_torch import data_path
    from deodr_tpu_torch import duck_scene as ds
    from deodr_tpu_torch.camera import default_camera
    from deodr_tpu_torch.geometry.mesh import ColoredTriMesh

    mesh = ColoredTriMesh.load(os.path.join(data_path, "duck.obj"))
    camera = default_camera(ds.DUCK_WIDTH, ds.DUCK_HEIGHT, 60, mesh.vertices.numpy(), np.diag([1.0, -1.0, -1.0]))
    inputs = dict(vertices=mesh.vertices, light_directional=ds.LIGHT_DIRECTIONAL, light_ambient=ds.LIGHT_AMBIENT,
                  uv=mesh.uv, texture=mesh.texture)
    inputs = {k: torch.as_tensor(v, dtype=dtype, device=device) for k, v in inputs.items()}
    return mesh, camera, inputs, np.array(ds.BACKGROUND_COLOR)


def surface_hand(device, dtype):
    """The hand of the RGB fit at its start (200 wide × 199 high, k1 = −1,
    the fit's colour, lights and background) → (mesh, camera, inputs by
    name, background colour, the fit's image)."""
    from deodr_tpu_torch.examples import rgb_image_hand_fitting as rgb_ex

    fitter = rgb_ex.make_fitter(device=device, dtype=dtype)
    vertices = fitter.vertices_init + fitter.transform_translation_init  # the start pose: no rotation
    inputs = dict(vertices=vertices, vertices_colors=np.tile(fitter.default_color, (len(vertices), 1)),
                  light_directional=fitter.default_light_directional, light_ambient=fitter.default_light_ambient)
    inputs = {k: torch.as_tensor(v, dtype=dtype, device=device) for k, v in inputs.items()}
    return fitter.mesh, fitter.camera, inputs, fitter.background_color, fitter.mesh_image


def surface_step(scene, camera, inputs, obs):
    """``Scene3DTorch.render`` of fresh leaves of ``inputs`` and the
    backward of Σ (image − obs)² → (image, gradients by name)."""
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in inputs.items()}
    image = scene.render(camera, **leaves)
    ((image - obs) ** 2).sum().backward()
    return image.detach(), {k: v.grad for k, v in leaves.items()}


def scene3d_step_of(mesh, camera, inputs, background, obs, device):
    """The port's ``Scene3D`` on a mesh of ``mesh``'s faces with the
    vertices, colours or texture and lights of ``inputs``: ``render`` +
    ``render_backward`` of Σ (image − obs)² → (image, gradients by name)."""
    from deodr_tpu_torch.geometry.mesh import ColoredTriMesh
    from deodr_tpu_torch.scene import Scene3D

    m = ColoredTriMesh(mesh.faces, inputs["vertices"], clockwise=mesh.clockwise, faces_uv=mesh.faces_uv,
                       uv=inputs.get("uv"), texture=inputs.get("texture"), colors=inputs.get("vertices_colors"))
    scene = Scene3D(sigma=1.0, device=device)
    scene.set_mesh(m)
    scene.set_light(inputs["light_directional"].cpu().numpy(), float(inputs["light_ambient"]))
    scene.set_background_color(background)
    image = scene.render(camera)
    scene.render_backward(2 * (image - obs))
    grads = dict(vertices=m._vertices_b, vertices_colors=m.vertices_colors_b, uv=getattr(m, "uv_b", None),
                 texture=getattr(m, "texture_b", None), light_directional=scene.light_directional_b,
                 light_ambient=scene.light_ambient_b)
    return image, {k: grads[k] for k in inputs}


def hold_surface(tag, got, want, say, limit_image, limit_grad):
    """Image and gradients of ``got`` against ``want`` (each (image, gradients by name))."""
    e_img = max_err(got[0], want[0])
    errs = {k: rel_err(got[1][k], want[1][k]) for k in want[1]}
    say(f"{tag}: image err {e_img:.3g} (limit {limit_image:g}), {'bit-equal' if e_img == 0 else 'not bit-equal'}; "
        f"gradient err of scale (limit {limit_grad:g}): " + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()))
    check(bool(torch.isfinite(got[0]).all()) and tuple(got[0].shape) == tuple(want[0].shape),
          f"{tag}: the image is not finite or has the wrong shape")
    check(all(bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0 for g in got[1].values()),
          f"{tag}: a gradient is non-finite or all zero")
    check(e_img <= limit_image and all(v <= limit_grad for v in errs.values()), f"{tag}: outside its tolerance")


def run_surface_scene(tag, scene_data, device, say, kernels_expected):
    """Phase 11a/b: ``Scene3DTorch`` in float32 with the kernels (launches
    zeroed before and read after) against ``impl="reference"``, and in
    float64 against the port's ``Scene3D`` → the float64 (mesh, camera,
    inputs, background, obs, Scene3D's buffers and plan capacity)."""
    from deodr_tpu_torch.interop import CameraTorch, Scene3DTorch
    from deodr_tpu_torch.ops import kernels

    results = {}
    for dtype in (torch.float32, torch.float64):
        mesh, camera, inputs, background, obs = scene_data(device, dtype)
        camera_t = CameraTorch.from_camera(camera)
        scenes = {}
        for impl in ("kernel", "reference"):
            scenes[impl] = Scene3DTorch(sigma=1.0, device=device, impl=impl)
            scenes[impl].set_mesh(mesh)
            scenes[impl].set_background_color(background)
        if obs is None:  # the target: the render plus 0.05, clipped, as bench.py's duck loss
            with torch.no_grad():
                obs = (scenes["kernel"].render(camera_t, **inputs) + 0.05).clamp(0.0, 1.0)
        obs = torch.as_tensor(obs, dtype=dtype, device=device)
        if dtype == torch.float32:
            kernels.reset_launches()
            got = surface_step(scenes["kernel"], camera_t, inputs, obs)
            launches = dict(kernels.LAUNCHES)
            say(f"launches of Scene3DTorch on the {tag}: {launches}")
            for name in kernels_expected:
                check(device.type != "cuda" or launches[name] > 0,
                      f"{name} was never launched by Scene3DTorch on the {tag}")
            hold_surface(f"Scene3DTorch on the {tag}, float32, against impl='reference'", got,
                         surface_step(scenes["reference"], camera_t, inputs, obs), say, SURFACE_LIMIT_IMAGE,
                         SURFACE_LIMIT_GRAD)
        else:
            got = surface_step(scenes["kernel"], camera_t, inputs, obs)
            hold_surface(f"Scene3DTorch on the {tag}, float64, against Scene3D", got,
                         scene3d_step_of(mesh, camera, inputs, background, obs, device), say, SURFACE_LIMIT_F64,
                         SURFACE_LIMIT_F64)
            results = dict(mesh=mesh, camera=camera, inputs=inputs, background=background, obs=obs)
    return results


def run_bridge(hand, device, say):
    """Phase 11c: ``render_scene_torch`` on the hand's float64 buffers
    against ``render_scene`` on the plan of ``plan_tiling``."""
    from deodr_tpu_torch.interop import render_scene_torch
    from deodr_tpu_torch.ops import kernels
    from deodr_tpu_torch.ops.render import render_scene
    from deodr_tpu_torch.scene import Scene3D, plan_tiling

    scene = Scene3D(sigma=1.0, device=device)
    scene.set_mesh(hand["mesh"])
    with torch.no_grad():
        inputs = hand["inputs"]
        buffers, _ = scene._build_buffers(hand["camera"], inputs["vertices"], inputs["vertices_colors"],
                                          inputs["light_directional"], inputs["light_ambient"], None, None, True)
    buffers = dataclasses.replace(buffers, background_color=torch.as_tensor(hand["background"], device=device))
    names = ("ij", "colors", "uv", "shade")
    cap = int(buffers.edgeflags.sum())
    tiling = plan_tiling(buffers.ij, buffers.faces, buffers.edgeflags, buffers.height, buffers.width, 1.0)
    check(tiling is not None, "render_scene_torch: the hand's 1048 faces did not plan the tiled route")

    def run(render):
        leaves = {k: getattr(buffers, k).detach().clone().requires_grad_(True) for k in names}
        image = render(leaves)
        ((image - hand["obs"]) ** 2).sum().backward()
        # an untextured scene reads no uv and no shade: they get no gradient
        return image.detach(), {k: v.grad for k, v in leaves.items() if v.grad is not None}

    kernels.reset_launches()
    got = run(lambda t: render_scene_torch(buffers, 1.0, t["ij"], t["colors"], t["uv"], t["shade"], None,
                                           aa_edge_capacity=cap))
    launches = dict(kernels.LAUNCHES)
    want = run(lambda t: render_scene(dataclasses.replace(buffers, **t), 1.0, aa_edge_capacity=cap, tiling=tiling)[0])
    say(f"render_scene_torch on the hand ({tiling}): launches {launches}")
    for name in UNTEXTURED_KERNELS:
        check(device.type != "cuda" or launches[name] > 0, f"{name} was never launched by render_scene_torch")
    check(torch.equal(got[0], want[0]), "render_scene_torch: the image differs from render_scene's on the same plan")
    check(set(got[1]) == set(want[1]) == {"ij", "colors"}, "render_scene_torch: not the gradients of render_scene")
    hold_surface("render_scene_torch on the hand, float64, against render_scene", got, want, say, 0.0,
                 BRIDGE_LIMIT_GRAD)


def run_surface_adam(device, say, scene3d_ms, smi_line):
    """Phase 11d: SURFACE_ADAM_STEPS steps of ``torch.optim.Adam`` on the
    duck's vertices, light and texture through ``Scene3DTorch``, from a
    seeded perturbation towards the unperturbed render → median ms a step."""
    from deodr_tpu_torch.interop import CameraTorch, Scene3DTorch

    mesh, camera, inputs, background = surface_duck(device, torch.float32)
    camera = CameraTorch.from_camera(camera)
    scene = Scene3DTorch(sigma=1.0, device=device)
    scene.set_mesh(mesh)
    scene.set_background_color(background)
    with torch.no_grad():
        target = scene.render(camera, **inputs)
    gen = torch.Generator(device="cpu").manual_seed(14)

    def moved(name, scale):
        noise = torch.randn(inputs[name].shape, generator=gen, dtype=torch.float32).to(device)
        return (inputs[name] + scale * noise).requires_grad_(True)

    extent = float((inputs["vertices"].amax(dim=0) - inputs["vertices"].amin(dim=0)).max())
    params = dict(vertices=moved("vertices", 2e-3 * extent), light_directional=moved("light_directional", 0.05),
                  texture=moved("texture", 0.05))
    optimizer = torch.optim.Adam([{"params": [params["vertices"]], "lr": 2e-4 * extent},
                                  {"params": [params["light_directional"], params["texture"]], "lr": 5e-3}])
    losses = []

    def step():
        optimizer.zero_grad()
        image = scene.render(camera, params["vertices"], light_directional=params["light_directional"],
                             light_ambient=inputs["light_ambient"], uv=inputs["uv"], texture=params["texture"])
        loss = ((image - target) ** 2).sum()
        loss.backward()
        optimizer.step()
        losses.append(loss.detach())

    ms = median_step_ms(step, device, reps=SURFACE_ADAM_STEPS - 3)  # after its three warm-up steps
    losses = [float(v) for v in losses]
    say(f"Scene3DTorch Adam on the duck: loss {losses[0]:.4f} -> {losses[-1]:.4f} in {len(losses)} steps")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0], "Scene3DTorch Adam: the loss did not fall")
    say(f"Scene3DTorch duck Adam step (render + backward + Adam): median {ms:.4f} ms beside phase 5's Scene3D duck "
        f"step {scene3d_ms:.4f} ms, on {smi_line}")
    return ms


def run_torch_surface(device, say, scene3d_ms, smi_line):
    """Phase 11; returns the median Adam step ms."""
    t0 = time.perf_counter()

    def duck(dev, dtype):
        return surface_duck(dev, dtype) + (None,)

    run_surface_scene("duck", duck, device, say, ("raster_fwd", "raster_bwd", "edge_tex_fwd", "edge_tex_bwd"))
    hand = run_surface_scene("hand", surface_hand, device, say, UNTEXTURED_KERNELS)
    run_bridge(hand, device, say)
    ms = run_surface_adam(device, say, scene3d_ms, smi_line)
    say(f"phase 11 (the torch class surface) took {time.perf_counter() - t0:.1f} s")
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

    def phase_took(n, what, t0):
        say(f"phase {n} ({what}) took {time.perf_counter() - t0:.1f} s")

    # 3. the untextured path on the bench scene
    t0 = time.perf_counter()
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
    phase_took(3, "the bench scene", t0)

    # 4. the textured path on the duck
    t0 = time.perf_counter()
    measured["duck"], launches["duck"], ms["duck"] = run_duck(device, say)
    phase_took(4, "the duck", t0)

    # 5. Scene3D on the duck, with and without the quad fetch (kernel B4)
    t0 = time.perf_counter()
    scene3d_measured, scene3d_launches, ms["scene3d"] = run_scene3d(device, say)
    measured.update(scene3d_measured)
    launches.update(scene3d_launches)
    phase_took(5, "Scene3D on the duck", t0)

    # 6. the untiled path and the remaining raster modes
    t0 = time.perf_counter()
    ms["untiled_bench"] = run_untiled_bench(scene, tiling, obs, device, say)
    measured["bench_nonstrict"], launches["bench_nonstrict"], ms["bench_nonstrict"] = run_bench_nonstrict(
        scene, tiling, obs, device, say)
    measured["duck_persp"], launches["duck_persp"], ms["duck_persp"] = run_duck_persp(device, say)
    ms["scene3d_untiled"] = run_scene3d_untiled(device, say)
    phase_took(6, "the untiled path and the raster modes", t0)

    # 7. the hand fitters (kernels B1 and B2 at the fitters' shapes)
    t0 = time.perf_counter()
    fit_measured, fit_launches, ms["fitters"] = run_fitters(device, say)
    measured.update(fit_measured)
    launches.update(fit_launches)
    phase_took(7, "the hand fitters", t0)

    # 8. the scenes: Scene2D (the triangle soup and the 2D texture fits untiled, above 256 faces tiled), the duck
    # through render_mesh (its golden, and render_deferred: B1f at D = 14)
    scene_measured, scene_launches, ms["scenes"] = run_scenes(device, say)
    measured.update(scene_measured)
    launches.update(scene_launches)

    # 9. large meshes: Scene3D on octahedron meshes of 8192-131072 faces, binned by supertiles and pairs (B1, B2),
    # and B1b split where its table does not fit shared memory
    measured["large_mesh"], launches["large_mesh"], ms["large_mesh"] = run_large_meshes(device, say)

    # 10. scale-out and auxiliaries: the tile-sharded bench at world size 1 (NCCL) and 2 (gloo), the duck's textured
    # multi-view step and the view-sharded fitter over 2 ranks, the Adam depth fit, a batch, the viewer
    scale_measured, scale_launches, ms["scale_out"] = run_scale_out(device, say)
    measured.update(scale_measured)
    launches.update(scale_launches)

    # 11. the torch class surface: Scene3DTorch on the duck (B1, B3) and the hand (B1, B2), render_scene_torch, Adam
    ms["torch_surface_adam"] = run_torch_surface(device, say, ms["scene3d"]["per-pixel"], smi_line)

    # 12. kernels line: one record per kernel and main path that launches it (the raster forward
    # runs on all thirteen, with 3 attribute planes on the bench scene, its band, Scene2D and the large mesh, 7 on the
    # duck (float64 on the multi-view duck), 8 on the perspective duck, 1 on the depth fit, 3 on the RGB fit and 14 on
    # the deferred duck), with the device times of every kernel and yardstick measured in one profiler run
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
