"""Readings that the limits of ``correct`` are set from, on the card at
the cell's own size: for each seed, the program's first steps against the
reference (the lower readings), the control (the reference in the next
precision down, put in the program's place) and the planted faults (the
upper readings). No measured window: the numbers read the first steps only.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,3 [--control-seeds 1,2,3]
        [--fault-seeds 1,2,3] [--device cuda] [--out FILE]

from the root of a checkout.

Prints one JSON line per reading and a summary line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[1]
LOWER = {"float64": "float32", "float32": "bfloat16"}


def readings(spec, seeds, control_seeds, fault_seeds, device, emit):
    import torch

    from perfbench import compare, reference
    from perfbench.faults import FAULTS
    from perfbench.fit import Fit
    from perfbench.inputs import make_inputs
    from perfbench.run import first_steps, reference_scene

    n = int(spec.traffic["checked_steps"])

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    for seed in sorted(set(seeds) | set(control_seeds) | set(fault_seeds)):
        t = time.perf_counter()
        inputs = make_inputs(spec.config, spec.traffic, seed, device)
        start = {"vertices": inputs.vertices, "colors": inputs.colors}
        ref = reference.adam_fit(reference_scene(inputs), inputs.target, inputs.vertices, inputs.colors,
                                 spec.traffic, steps=n)
        sync()
        t_ref = time.perf_counter() - t
        runs = []
        if seed in seeds:
            runs.append(("program", None))
        if seed in fault_seeds:
            runs += [(name, FAULTS[name]) for name in ("half_rows", "altered")]
        for kind, fault in runs:
            t = time.perf_counter()
            if fault is None:
                program = first_steps(Fit(inputs, spec.traffic, device), n)
            else:
                with fault():
                    program = first_steps(Fit(inputs, spec.traffic, device), n)
            sync()
            emit({"seed": seed, "kind": kind, "numbers": compare.gaps(program, ref, start),
                  "seconds": time.perf_counter() - t, "reference_seconds": t_ref})
        if seed in control_seeds:
            lower = getattr(torch, LOWER[spec.config["dtype"]])
            t = time.perf_counter()
            control = reference.adam_fit(reference_scene(inputs), inputs.target, inputs.vertices, inputs.colors,
                                         spec.traffic, steps=n, dtype=lower)
            sync()
            emit({"seed": seed, "kind": "control", "dtype": LOWER[spec.config["dtype"]],
                  "numbers": compare.gaps(control, ref, start), "seconds": time.perf_counter() - t})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    os.environ.setdefault("DEODR_KERNEL_BUILD_DIR", str(CHECKOUT / "build" / "perfbench" / "kernels"))
    import torch

    from perfbench.run import load_cell

    def ints(s):
        return [int(x) for x in s.split(",") if x]

    spec = load_cell(Path.cwd(), args.workload)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    out = open(args.out, "a") if args.out else None
    rows = []

    def emit(row):
        row = {"workload": args.workload, **row}
        rows.append(row)
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    readings(spec, ints(args.seeds), ints(args.control_seeds), ints(args.fault_seeds), device, emit)
    summary = {}
    for kind in sorted({r["kind"] for r in rows}):
        picked = [r["numbers"] for r in rows if r["kind"] == kind]
        pick = max if kind == "program" else min
        summary[kind] = {k: pick(p[k] for p in picked) for k in picked[0]}
    emit({"summary": summary, "note": "program: largest reading; control and faults: smallest"})
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    if str(CHECKOUT) not in sys.path:
        sys.path.insert(0, str(CHECKOUT))
    sys.exit(main())
