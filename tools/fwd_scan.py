"""Device time per call of the textured edge forward (B3f) and quad-blend
forward (B4f) kernels, and of the edge backward kernels beside them, on the
card, at chip_smoke.py's shapes (its own helpers build the inputs, image
mode, float32):

- ``edge_tex_fwd`` and ``edge_tex_bwd`` on the duck's textured edge tables,
  from ``render_scene``'s constant plan (``duck``) and from the buffers that
  ``Scene3D`` builds through its own planner (``duck_scene3d``);
- ``quad_blend_fwd`` on the duck's 32256 quads (``Scene3D`` with the quad
  fetch), and ``grid_sample``'s forward of the same function;
- ``edge_bwd`` on the bench scene's edge tables.

Each line gives the device time of one call (``chip_smoke.device_times``:
every function in one profiler session, its own kernel checked by name),
once per repetition.

Usage, on a machine with one CUDA card, from the repository root:
``python3 tools/fwd_scan.py [--port DIR] [--reps R]``. ``--port DIR``
imports ``deodr_tpu_torch`` from the checkout DIR instead of this one (a
``git archive`` of another commit unpacked under the gitignored ``build/``,
with its ``data/``), so that two versions of the kernels run on the same
inputs; chip_smoke.py always comes from this checkout. Compare two versions
within one call only, in turns (other, this, this, other). Imports no JAX;
exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--port", type=Path, help="checkout to import deodr_tpu_torch from")
    parser.add_argument("--reps", type=int, default=2, help="profiler sessions, one line per function each")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("fwd_scan: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke as cs  # imports the port only inside its functions

    if args.port is not None:
        sys.path.insert(0, str(args.port.resolve()))
    import torch.nn.functional as F

    import deodr_tpu_torch
    from deodr_tpu_torch import duck_scene as ds
    from deodr_tpu_torch.ops.kernels import edge_kernel as ek
    from deodr_tpu_torch.ops.kernels import edge_tex_kernel as etk
    from deodr_tpu_torch.ops.kernels import quad_blend_kernel as qbk

    device = torch.device("cuda")
    print(f"port: {Path(deodr_tpu_torch.__file__).resolve().parent}", flush=True)
    gen = torch.Generator().manual_seed(0)
    fns = {}  # (kernel, path) → (function, the name of the hand kernel it launches, or None)
    with torch.no_grad():
        _, duck_scene, duck_obs = cs.duck_setup(device)
        duck_in = cs.edge_inputs(duck_scene, ds.DUCK_TILING, duck_obs, ds.DUCK_SIGMA, ds.DUCK_AA_EDGE_CAPACITY,
                                 ds.DUCK_TEX_PLAN)[False]
        s3d, camera = cs.duck_scene3d(device, quad_fetch=False)
        cap, tiling, _, _, tex_plan = s3d._eager_plan(camera)
        s3d_obs = (s3d.render(camera) + 0.05).clamp(0.0, 1.0)
        buffers, _ = s3d._build_buffers(camera, *s3d._diff_inputs(False), True)
        s3d_in = cs.edge_inputs(buffers, tiling, s3d_obs, ds.DUCK_SIGMA, cap, tex_plan)[False]
        for path, (et, buf, z_pad, obs_pad), texture in (("duck", duck_in, duck_scene.texture),
                                                           ("duck_scene3d", s3d_in, buffers.texture)):
            fargs = (et.table_tile, texture, buf, z_pad, obs_pad, et.counts, et.grid, False)
            final = etk.edge_tex_fwd(*fargs)
            err = cs.max_err(final, etk.edge_tex_fwd(*fargs, impl="reference"))
            print(f"edge_tex_fwd {path}: {et.grid.n_tiles} tiles of {et.grid.tile_h}x{et.grid.tile_w}, "
                  f"err {err:.3g} against the plain version", flush=True)
            bargs = (et.table_tile, texture, final, z_pad, obs_pad, torch.rand(final.shape, generator=gen).to(device),
                     et.counts, et.grid, False)
            fns[("edge_tex_fwd", path)] = (lambda a=fargs: etk.edge_tex_fwd(*a), "edge_tex_fwd_kernel")
            fns[("edge_tex_bwd", path)] = (lambda a=bargs: etk.edge_tex_bwd(*a), "edge_tex_bwd_kernel")

        quad, _ = cs.duck_scene3d(device, quad_fetch=True)
        win, dv, du, ev, eu = inputs = cs.capture_quad_blend_inputs(quad, camera)
        q, c = win.shape[0], win.shape[1] // 64
        print(f"quad_blend_fwd duck_quad: {q} quads, C = {c}, equal to the plain version: "
              f"{torch.equal(qbk.quad_blend_fwd(*inputs), qbk.quad_blend_fwd(*inputs, impl='reference'))}", flush=True)
        windows = win.reshape(q, 8, 8, c).permute(0, 3, 1, 2).contiguous()
        grid = torch.stack([(du + eu) * (2.0 / 7.0) - 1.0, (dv + ev) * (2.0 / 7.0) - 1.0], dim=-1)[:, None]
        fns[("quad_blend_fwd", "duck_quad")] = (lambda: qbk.quad_blend_fwd(*inputs), "quad_blend_fwd_kernel")
        fns[("grid_sample", "duck_quad")] = (
            lambda: F.grid_sample(windows, grid, mode="bilinear", padding_mode="zeros", align_corners=True), None)

        _, scene, bench_tiling, obs = cs.bench_setup(device)
        et, buf, z_pad, obs_pad = cs.edge_inputs(scene, bench_tiling, obs, 1.0, cs.AA_EDGE_CAPACITY)[False]
        final = ek.edge_fwd(et.table_tile, buf, z_pad, obs_pad, et.counts, et.grid, False)
        bargs = (et.table_tile, final, z_pad, obs_pad, torch.rand(final.shape, generator=gen).to(device), et.counts,
                 et.grid, False)
        fns[("edge_bwd", "bench")] = (lambda: ek.edge_bwd(*bargs), "edge_bwd_kernel")

    for rep in range(args.reps):
        try:
            times = cs.device_times(fns, device, reps=20)
        except cs.Failure as e:
            print(f"rep {rep}: not measured ({e})", flush=True)
            continue
        for (name, path), (ms, ops) in times.items():
            print(f"rep {rep} {name} {path}: device ms per call {ms:.5f}, device operations per call {ops:g}",
                  flush=True)
    smi = cs.subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                            capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
