"""Smoke run of the PyTorch / CUDA port (deodr_tpu_torch) on one GPU.

Usage: ``python3 chip_smoke.py`` from the repository root, on a machine
with one CUDA card (exits non-zero, printing no result, without one).

Phases, each of which fails the run (non-zero exit) on any miss:

1. device: the card's name and ``nvidia-smi`` name / power limit;
2. build: compiles the kernels from ``deodr_tpu_torch/csrc`` (timed);
3. each kernel against its plain PyTorch version on the card, at the bench
   shapes (512², 200 triangles, 48×128 tiles, float32): slot_map exact,
   z within 1e-5, images within 1e-4, gradient tables within 1e-3 of
   their scale; times of kernel and plain version;
4. the main path: ``render_scene`` forward + backward at σ = 0 and σ = 1,
   image and error mode, with ``check_capacity=True``, held against the
   same call with ``impl="reference"``; launch counts are zeroed just
   before and read just after;
5. a 20-step gradient descent on ``ij`` and ``colors`` towards the
   unperturbed render (the loss must fall), then the median fwd+bwd step
   time and Mpix/s at σ = 0 and σ = 1 (CUDA events, after warm-up), and a
   ``torch.profiler`` breakdown of one σ = 1 step (device busy share,
   device operations per step, heaviest operations);
6. one JSON line ``{"kernels": [...]}`` (launches on the main path, error,
   times, the least time the card could take);
7. last line ``{"ok": true, "device": {...}}``.

The bench scene comes from ``deodr_tpu_torch.bench_scene`` (numpy, seed 0,
as ``bench.py`` builds it); nothing of JAX or of the JAX package is imported.
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
# the few pixels inside a band is left out, so the bound stays a lower bound
OPS_PER_VISIT = {"raster_fwd": 33, "edge_fwd": 33, "edge_bwd": 33}
KERNEL_SOURCES = {
    "raster_fwd": ("deodr_tpu_torch/csrc/raster_kernel.cu", "deodr_tpu/ops/pallas/raster_kernel.py:137"),
    "raster_bwd": ("deodr_tpu_torch/csrc/raster_kernel.cu", "deodr_tpu/ops/pallas/raster_kernel.py:193"),
    "edge_fwd": ("deodr_tpu_torch/csrc/edge_kernel.cu", "deodr_tpu/ops/pallas/edge_kernel.py:150"),
    "edge_bwd": ("deodr_tpu_torch/csrc/edge_kernel.cu", "deodr_tpu/ops/pallas/edge_kernel.py:202"),
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


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S, n_ops / PEAK_F32_OPS_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def check_kernels(scene, tiling, obs, device, say):
    """Phase 3: each kernel against its plain version at the main path's
    shapes; returns per-kernel measurements."""
    from deodr_tpu_torch.ops.edge_aa import EdgeAAConfig
    from deodr_tpu_torch.ops.kernels import edge_kernel as ek
    from deodr_tpu_torch.ops.kernels import raster_kernel as rk
    from deodr_tpu_torch.ops.render import _build_edge_data, prepare
    from deodr_tpu_torch.ops.tiled import edge_tables, pad_edge_buffers, raster_tables, rasterize_tiled_kernel

    gen = torch.Generator(device="cpu").manual_seed(1)
    out = {}
    with torch.no_grad():
        ij_off, signed_area, draw, background = prepare(scene)
        rt = raster_tables(scene, ij_off, draw, tiling)
        grid, cap_r = rt.grid, rt.setup_tile.shape[1]
        n_px = grid.tile_h * grid.tile_w
        visits = n_px * int(rt.counts.to(torch.int64).clamp(max=cap_r).sum())
        d = rt.affine_tile.shape[2] // 3
        esz = rt.affine_tile.element_size()

        s_ref, z_ref, v_ref = rk.raster_fwd(rt.setup_tile, rt.affine_tile, rt.counts, grid, impl="reference")
        s_k, z_k, v_k = rk.raster_fwd(rt.setup_tile, rt.affine_tile, rt.counts, grid)
        check(torch.equal(s_ref, s_k), "raster_fwd slot_map differs from the plain version")
        fin = torch.isfinite(z_ref)
        check(torch.equal(fin, torch.isfinite(z_k)), "raster_fwd coverage differs")
        e_z = max_err(z_k[fin], z_ref[fin])
        e_v = max_err(v_k, v_ref)
        say(f"raster_fwd: slot_map exact, z err {e_z:.3g} (limit 1e-5), vals err {e_v:.3g} (limit 1e-4)")
        check(e_z <= 1e-5 and e_v <= 1e-4, "raster_fwd outside its tolerance")
        rows = int(rt.counts.to(torch.int64).clamp(max=cap_r).sum())
        p_total = grid.n_tiles * n_px
        out["raster_fwd"] = dict(
            max_abs_err=max(e_z, e_v),
            ms=time_ms(lambda: rk.raster_fwd(rt.setup_tile, rt.affine_tile, rt.counts, grid), 50, device),
            plain_ms=time_ms(lambda: rk.raster_fwd(rt.setup_tile, rt.affine_tile, rt.counts, grid, impl="reference"),
                             3, device),
            bound=bound_ms(rows * (22 + 3 * d) * esz + grid.n_tiles * 4 + p_total * (4 + esz * (1 + d)),
                           visits * OPS_PER_VISIT["raster_fwd"] + p_total * 4 * d),
        )

        g_vals = torch.rand(v_ref.shape, generator=gen, dtype=v_ref.dtype).to(device)
        gt_ref = rk.raster_bwd(s_ref, g_vals, rt.counts, grid, cap_r, impl="reference")
        gt_k = rk.raster_bwd(s_ref, g_vals, rt.counts, grid, cap_r)
        e_g = rel_err(gt_k, gt_ref)
        say(f"raster_bwd: g_table err {e_g:.3g} of scale (limit 1e-3)")
        check(e_g <= 1e-3, "raster_bwd outside its tolerance")
        out["raster_bwd"] = dict(
            max_abs_err=max_err(gt_k, gt_ref),
            ms=time_ms(lambda: rk.raster_bwd(s_ref, g_vals, rt.counts, grid, cap_r), 50, device),
            plain_ms=time_ms(lambda: rk.raster_bwd(s_ref, g_vals, rt.counts, grid, cap_r, impl="reference"), 3, device),
            bound=bound_ms(p_total * (4 + esz * d) + rows * 3 * d * esz, p_total * 6 * d),
        )

        # edge pass inputs: the solid pass's image and z-buffer, the bench's edges
        image, z_buffer, _ = rasterize_tiled_kernel(scene, ij_off, draw, background, tiling, impl="reference")
        edges = _build_edge_data(scene, ij_off, signed_area, AA_EDGE_CAPACITY)
        for name in ("edge_fwd", "edge_bwd"):
            out[name] = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound=(0.0, "operations"))
        for error_mode in (False, True):
            mode = "error" if error_mode else "image"
            cfg = EdgeAAConfig(scene.height, scene.width, 1.0, scene.clockwise, error_mode)
            et = edge_tables(cfg, edges, z_buffer, tiling)
            buffer = ((image - obs) ** 2).sum(dim=-1) if error_mode else image
            buf, z_pad, obs_pad = pad_edge_buffers(cfg, buffer, z_buffer, obs, et.grid)
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
            out["edge_fwd"]["max_abs_err"] = max(out["edge_fwd"]["max_abs_err"], e_o)
            out["edge_bwd"]["max_abs_err"] = max(out["edge_bwd"]["max_abs_err"], max_err(gr_k, gr_ref), e_b)
            if not error_mode:  # times and bounds in image mode, the bench's mode
                e_cap = et.table_tile.shape[1]
                e_rows = int(et.counts.to(torch.int64).clamp(max=e_cap).sum())
                e_visits = et.grid.tile_h * et.grid.tile_w * e_rows
                w_row, c = et.table_tile.shape[2], buf.shape[0]
                p_e = et.grid.n_tiles * et.grid.tile_h * et.grid.tile_w
                out["edge_fwd"].update(
                    ms=time_ms(lambda: ek.edge_fwd(*args), 50, device),
                    plain_ms=time_ms(lambda: ek.edge_fwd(*args, impl="reference"), 3, device),
                    bound=bound_ms(e_rows * w_row * esz + p_e * esz * (2 * c + 1),
                                   e_visits * OPS_PER_VISIT["edge_fwd"]),
                )
                out["edge_bwd"].update(
                    ms=time_ms(lambda: ek.edge_bwd(*bargs), 20, device),
                    plain_ms=time_ms(lambda: ek.edge_bwd(*bargs, impl="reference"), 3, device),
                    bound=bound_ms(e_rows * (w_row + 3 + 3 * c) * esz + p_e * esz * (3 * c + 1),
                                   e_visits * OPS_PER_VISIT["edge_bwd"]),
                )
    return out


def loss_and_grads(scene, sigma, tiling, obs, error_mode, impl, check_capacity=True):
    from deodr_tpu_torch import render_scene

    ij = scene.ij.detach().clone().requires_grad_(True)
    colors = scene.colors.detach().clone().requires_grad_(True)
    s = dataclasses.replace(scene, ij=ij, colors=colors)
    image, _, err = render_scene(
        s, sigma, antialiase_error=error_mode, obs=obs, aa_edge_capacity=AA_EDGE_CAPACITY, tiling=tiling,
        impl=impl, check_capacity=check_capacity,
    )
    out = err if error_mode else image
    loss = out.sum() if error_mode else ((image - obs) ** 2).sum()
    loss.backward()
    return out.detach(), loss.detach(), ij.grad, colors.grad


def main_path(scene, tiling, obs, say):
    """Phase 4: the main path on the kernels against impl='reference'."""
    for sigma in (0.0, 1.0):
        for error_mode in (False, True):
            tag = f"sigma={sigma:g} {'error' if error_mode else 'image'} mode"
            o_k, l_k, gij_k, gc_k = loss_and_grads(scene, sigma, tiling, obs, error_mode, "kernel")
            o_r, l_r, gij_r, gc_r = loss_and_grads(scene, sigma, tiling, obs, error_mode, "reference")
            check(all(bool(torch.isfinite(g).all()) for g in (gij_k, gc_k)), f"{tag}: non-finite gradients")
            e_o, e_ij, e_c = max_err(o_k, o_r), rel_err(gij_k, gij_r), rel_err(gc_k, gc_r)
            say(f"main path {tag}: loss {float(l_k):.6f} vs {float(l_r):.6f}, out err {e_o:.3g} (limit 1e-4), "
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


def step_times(scene, tiling, obs, device, reps=20):
    """Median ms of one fwd+bwd step (render, loss, backward) per σ."""
    out = {}
    for sigma in (0.0, 1.0):
        def step():
            loss_and_grads(scene, sigma, tiling, obs, False, "kernel", check_capacity=False)

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
        out[sigma] = statistics.median(times)
    return out


def profile_step(scene, tiling, obs, device, say, steps=5):
    """Where one σ = 1 fwd+bwd step spends its time: host wall clock per
    step (profiler on), device busy time (sum of the card's kernel and copy
    durations, one stream) and the number of device operations per step,
    and the device time of the heaviest operations by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def step():
        loss_and_grads(scene, 1.0, tiling, obs, False, "kernel", check_capacity=False)

    if device.type != "cuda":
        say("profile: not measured (no card)")
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
        say(f"profile sigma=1: wall {wall_ms:.4f} ms/step; device time not measured (the profiler saw no device ops)")
        return
    by_name = {}
    for e in device_ops:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / steps
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    say(f"profile sigma=1: wall {wall_ms:.4f} ms/step (profiler on), device busy {busy:.4f} ms/step "
        f"({100 * busy / wall_ms:.2f}% of wall), {len(device_ops) / steps:.0f} device ops/step")
    say("profile top device time (ms/step): " + "; ".join(f"{name[:60]} {ms:.4f}" for name, ms in top))


def run(device="cuda", height=512, width=512, n_tri=200, smi_line=None):
    """All phases; raises on any miss. Returns the kernels record."""
    from deodr_tpu_torch import scene_buffers_from_numpy, suggest_tiling
    from deodr_tpu_torch.bench_scene import bench_scene_fields
    from deodr_tpu_torch.ops import kernels

    device = torch.device(device)

    def say(msg):
        print(msg, flush=True)

    # 1. device
    if device.type == "cuda":
        say(f"device: {torch.cuda.get_device_name(0)}")
    say(smi_line if smi_line is not None else "nvidia-smi: not run (rehearsal on the CPU)")

    # 2. build
    if device.type == "cuda":
        t0 = time.perf_counter()
        path = kernels.build()
        kernels.library()
        say(f"build: {path.name} in {time.perf_counter() - t0:.1f} s")

    fields = bench_scene_fields(height, width, n_tri)
    scene = scene_buffers_from_numpy(fields, device=device, dtype=torch.float32)
    tiling = suggest_tiling(fields["ij"], fields["faces"], height, width, sigma=1.0,
                            edgeflags=fields["edgeflags"], margin=1.0, for_pallas=True, bucket_mode="exact")
    say(f"tiling: {tiling}")
    obs = torch.from_numpy(np.random.RandomState(3).rand(height, width, 3).astype(np.float32)).to(device)

    # 3. each kernel against its plain version
    measured = check_kernels(scene, tiling, obs, device, say)

    # 4. the main path, with launch counts zeroed just before and read just after
    kernels.reset_launches()
    main_path(scene, tiling, obs, say)
    launches = dict(kernels.LAUNCHES)
    say(f"launches on the main path: {launches}")
    for name in kernels.KERNEL_NAMES:
        check(device.type != "cuda" or launches[name] > 0, f"{name} was never launched on the main path")

    # 5. trainer and step times
    train(scene, tiling, device, say)
    ms = step_times(scene, tiling, obs, device)
    for sigma, t in ms.items():
        say(f"fwd+bwd step sigma={sigma:g}: median {t:.4f} ms, {height * width / (t * 1e-3) / 1e6:.2f} Mpix/s")
    profile_step(scene, tiling, obs, device, say)

    # 6. kernels line
    record = []
    for name in kernels.KERNEL_NAMES:
        m = measured[name]
        source, replaces = KERNEL_SOURCES[name]
        record.append(dict(
            name=name, route="cuda", source=source, replaces=replaces, launches=launches[name],
            max_abs_err=m["max_abs_err"], ms=m["ms"], plain_ms=m["plain_ms"], bound_ms=m["bound"][0],
            bound_by=m["bound"][1], library_ms=None,
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
