"""Where the edge backward kernels' time goes, on the card:

1. device time per call of ``edge_bwd`` on the bench scene and of
   ``edge_tex_bwd`` on the duck (image mode, chip_smoke.py's tables, built
   by its own helpers) with every tile's slot count clamped to K, for K = 0,
   1, 4, 8, 16, 32, 64 and all. K = 0 is the cost of the frame alone (the
   pixel planes, the zero rows and the launch); the rise with K is the slot
   walk, and a jump where K passes a multiple of the chunk a chunk's cost;
2. ``edge_tex_bwd`` on the duck at textured edge tiles of 8 (the plan's),
   32 and 48 rows of 128, each table as deep as its fullest tile (rounded
   up to a multiple of 8).

Usage, on a machine with one CUDA card, from the repository root:
``python3 tools/edge_bwd_scan.py [--port DIR]``. ``--port DIR`` imports
``deodr_tpu_torch`` from the checkout DIR instead of this one, so that
another version of the kernels is timed on the same tables; chip_smoke.py
always comes from this checkout. Imports no JAX; exits non-zero without a
card.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

KS = (0, 1, 4, 8, 16, 32, 64, 1 << 30)
TEX_TILE_HEIGHTS = (8, 32, 48)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--port", type=Path, help="checkout to import deodr_tpu_torch from")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("edge_bwd_scan: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke as cs  # imports the port only inside its functions

    if args.port is not None:
        sys.path.insert(0, str(args.port.resolve()))
    import deodr_tpu_torch
    from deodr_tpu_torch import duck_scene as ds
    from deodr_tpu_torch.ops.kernels import edge_kernel as ek
    from deodr_tpu_torch.ops.kernels import edge_tex_kernel as etk

    device = torch.device("cuda")
    print(f"port: {Path(deodr_tpu_torch.__file__).resolve().parent}")
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        _, scene, tiling, obs = cs.bench_setup(device)
        bench_et, buf, z_pad, obs_pad = cs.edge_inputs(scene, tiling, obs, 1.0, cs.AA_EDGE_CAPACITY)[False]
        final = ek.edge_fwd(bench_et.table_tile, buf, z_pad, obs_pad, bench_et.counts, bench_et.grid, False)
        bench = (bench_et.table_tile, final, z_pad, obs_pad, torch.rand(final.shape, generator=gen).to(device))

        _, duck_scene, duck_obs = cs.duck_setup(device)
        duck = {}  # textured edge tile height → (tables, edge_tex_bwd's arguments before the counts)
        for tile_h in TEX_TILE_HEIGHTS:
            cap = ds.DUCK_TILING.edge_capacity if tile_h == ds.DUCK_TILING.edge_tile_h else 1024
            for _ in range(2):  # the second time as deep as the fullest tile
                tiling = ds.DUCK_TILING._replace(edge_tile_h=tile_h, edge_capacity=cap)
                inputs = cs.edge_inputs(duck_scene, tiling, duck_obs, ds.DUCK_SIGMA, ds.DUCK_AA_EDGE_CAPACITY,
                                        ds.DUCK_TEX_PLAN)
                et, buf, z_pad, obs_pad = inputs[False]
                fullest = int(et.counts.max())
                if tile_h == ds.DUCK_TILING.edge_tile_h or cap == -(-fullest // 8) * 8:
                    break
                cap = -(-fullest // 8) * 8
            final = etk.edge_tex_fwd(et.table_tile, duck_scene.texture, buf, z_pad, obs_pad, et.counts, et.grid,
                                     False)
            g_out = torch.rand(final.shape, generator=gen).to(device)
            duck[tile_h] = (et, (et.table_tile, duck_scene.texture, final, z_pad, obs_pad, g_out))
            counts = et.counts.cpu()
            print(f"duck textured edge tiles of {tile_h}x{et.grid.tile_w}: {counts.numel()}, without slots "
                  f"{int((counts == 0).sum())}, more than 16 slots {int((counts > 16).sum())}, fullest "
                  f"{int(counts.max())}, capacity {et.table_tile.shape[1]}")
    print(f"bench edge tiles of {bench_et.grid.tile_h}x{bench_et.grid.tile_w}: {bench_et.grid.n_tiles}, fullest "
          f"{int(bench_et.counts.max())}")

    fns = {}
    duck_et, duck_args = duck[ds.DUCK_TILING.edge_tile_h]
    for k in KS:
        cb = bench_et.counts.clamp(max=k).contiguous()
        cd = duck_et.counts.clamp(max=k).contiguous()
        fns[("edge_bwd bench", k)] = (lambda cb=cb: ek.edge_bwd(*bench, cb, bench_et.grid, False), "edge_bwd_kernel")
        fns[("edge_tex_bwd duck", k)] = (lambda cd=cd: etk.edge_tex_bwd(*duck_args, cd, duck_et.grid, False),
                                         "edge_tex_bwd_kernel")
    for tile_h, (et, a) in duck.items():
        fns[("edge_tex_bwd duck tiles", tile_h)] = (
            lambda et=et, a=a: etk.edge_tex_bwd(*a, et.counts, et.grid, False), "edge_tex_bwd_kernel")
    for rep in range(2):
        times = cs.device_times(fns, device, reps=20)
        for name in ("edge_bwd bench", "edge_tex_bwd duck"):
            print(f"rep {rep} {name}, device ms per call by K: " + ", ".join(
                f"{'all' if k == KS[-1] else k}: {times[(name, k)][0]:.5f}" for k in KS))
        print(f"rep {rep} edge_tex_bwd duck, device ms per call by textured edge tile height: " + ", ".join(
            f"{h}: {times[('edge_tex_bwd duck tiles', h)][0]:.5f}" for h in TEX_TILE_HEIGHTS))
    smi = cs.subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                            capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
