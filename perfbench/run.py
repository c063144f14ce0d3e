"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Set-up (imports, the kernels' library from
``build/perfbench/kernels`` in the checkout, built there on the first run,
the inputs from the seed, the fit and its first steps, the warm-up) is
timed as ``setup_s``; then the window runs the fit's steps for
``--seconds`` (``--trace 0``), or the traffic's ``trace_steps`` steps under
the profiler (``--trace 1``). Once the window has closed and the memory
peak is read, the program's state is freed and the plain reference follows
the fit's first steps on the same inputs; the numbers compared go to the
last lines of standard error and to the result's ``checks``. The last line
of standard output is the result. A run without enough CUDA devices exits
with code 1 and prints no result, as does one in which JAX or the JAX
package was imported.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

CHECKOUT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "deodr_tpu")
KERNEL_BUILD_DIR = CHECKOUT / "build" / "perfbench" / "kernels"


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the benchmark may not load,
    compared whole (``deodr_tpu_torch`` is not ``deodr_tpu``)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def load_cell(root: Path, workload: str) -> SimpleNamespace:
    """The cell ``workload`` of ``root/BENCHMARK.json`` with its
    configuration, traffic, limits and the metrics it reports."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    config_file = {c["name"]: c["file"] for c in bench["configs"]}[cell["config"]]
    data = root / "perfbench"

    def metrics(kind):
        return [m for m in bench[kind] if workload in m.get("workloads", [workload])]

    return SimpleNamespace(
        cell=cell, config=json.loads((root / config_file).read_text()),
        traffic=json.loads((data / "traffic" / f"{cell['traffic']}.json").read_text()),
        limits=json.loads((data / "limits" / f"{workload}.json").read_text()),
        end_to_end=metrics("end_to_end"), per_layer=metrics("per_layer"), root=root,
    )


def load_reader(root: Path, name: str):
    """The ``read(ctx)`` of ``perfbench/metrics/<name>.py``."""
    path = root / "perfbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("perfbench_metric_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


class StepTimer:
    """Each step's duration: CUDA events on the card (the device's clock
    from the step's first launch to its last operation), the host clock
    elsewhere."""

    def __init__(self, device):
        import torch

        self.cuda = device.type == "cuda"
        self._torch = torch
        self.marks = []

    def start(self):
        if self.cuda:
            ev = self._torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append([ev])
        else:
            self.marks.append([time.perf_counter()])

    def stop(self):
        if self.cuda:
            ev = self._torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks[-1].append(ev)
        else:
            self.marks[-1].append(time.perf_counter())

    def seconds(self) -> list:
        if self.cuda:
            return [a.elapsed_time(b) * 1e-3 for a, b in self.marks]
        return [b - a for a, b in self.marks]


def first_steps(fit, n: int):
    """The fit's first ``n`` steps through its own step: each step's loss,
    the first gradient as Adam received it, the parameters after them."""
    from perfbench.reference import FitResult

    losses, first = [], {}
    for k in range(n):
        losses.append(float(fit.step()))
        if k == 0:
            first = fit.gradients()
    return FitResult(losses, first, fit.values())


def reference_scene(inputs):
    from perfbench.reference import Scene

    return Scene(inputs.faces, inputs.extrinsic, inputs.intrinsic, inputs.height, inputs.width,
                 inputs.light_directional, inputs.light_ambient, inputs.background, inputs.sigma)


def run_cell(spec: SimpleNamespace, seed: int, seconds: float, trace: bool, device, log=print) -> dict:
    """Set up, measure, check and return the result of one run."""
    import torch

    from perfbench import compare, reference
    from perfbench.inputs import make_inputs

    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    config, traffic = spec.config, spec.traffic
    setup = {}
    from perfbench.fit import Fit  # imports the port

    setup["import_s"] = time.perf_counter() - _T0
    if cuda:
        from deodr_tpu_torch.ops import kernels

        t = time.perf_counter()
        setup["kernels_built"] = not any(KERNEL_BUILD_DIR.glob("*.so"))
        kernels.library()
        setup["kernel_load_s"] = time.perf_counter() - t
    t = time.perf_counter()
    inputs = make_inputs(config, traffic, seed, device)
    sync()
    setup["inputs_s"] = time.perf_counter() - t

    t = time.perf_counter()
    fit = Fit(inputs, traffic, device)
    start = fit.values()
    program = first_steps(fit, int(traffic["checked_steps"]))
    sync()
    setup["checked_steps_s"] = time.perf_counter() - t
    t = time.perf_counter()
    for _ in range(int(traffic["warmup_steps"])):
        fit.step()
    sync()
    setup["warmup_s"] = time.perf_counter() - t
    setup_s = time.perf_counter() - _T0
    log(json.dumps({"setup_breakdown": {**setup, "setup_s": setup_s}}), file=sys.stderr)

    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    gc.collect()
    timer = StepTimer(device)
    step_losses = []
    traced = None
    if trace:
        from perfbench.trace import profile_steps

        traced = profile_steps(lambda: step_losses.append(fit.step()), int(traffic["trace_steps"]), sync)
        window_s, n_steps = traced.window_s, traced.steps
    else:
        sync()
        t0 = time.perf_counter()
        while True:
            timer.start()
            step_losses.append(fit.step())
            timer.stop()
            sync()
            if time.perf_counter() - t0 >= seconds:
                break
        window_s, n_steps = time.perf_counter() - t0, len(step_losses)
        times = sorted(timer.seconds())
        log(json.dumps({"step_ms_quantiles": [times[int(q * (len(times) - 1))] * 1e3 for q in (0, .25, .5, .75, 1)]}),
            file=sys.stderr)
    window_peak = torch.cuda.max_memory_allocated() if cuda else 0
    failed = int((~torch.isfinite(torch.stack(step_losses))).sum())

    # the program's state goes before the reference runs
    del fit
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ref_scene = reference_scene(inputs)
    ref = reference.adam_fit(ref_scene, inputs.target, inputs.vertices, inputs.colors, traffic,
                             steps=int(traffic["checked_steps"]))
    numbers = compare.gaps(program, ref, start)
    correct, checks = compare.judge(numbers, spec.limits)
    log(json.dumps({"not_compared": {k: v for k, v in numbers.items() if k not in checks}}), file=sys.stderr)

    kind = torch.cuda.get_device_name(0) if cuda else "cpu"
    ctx = SimpleNamespace(
        step_seconds=timer.seconds(), window_s=window_s, n_steps=n_steps, setup_s=setup_s,
        window_peak_bytes=window_peak, trace=traced, root=spec.root, dtype=config["dtype"],
        itemsize=inputs.vertices.element_size(), device_kind=kind, sizes=None,
    )
    if trace:
        from perfbench.roofline import scene_sizes

        ctx.sizes = scene_sizes(ref_scene, inputs.vertices, inputs.colors.shape[1])
    metrics = {}
    for m in spec.per_layer if trace else spec.end_to_end:
        value = load_reader(spec.root, m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = {"platform": "gpu" if cuda else "cpu", "kind": kind, "count": int(spec.cell["chips"]),
                   "memory_peak_bytes": int(max(setup_peak, window_peak))}
    result = {"correct": bool(correct and failed == 0), "attempted": n_steps, "failed": failed,
              "metrics": metrics, "device": device_info}
    if trace:
        from perfbench.trace import idle_gaps, top_device_ops

        device_info["busy_s"] = traced.busy_us * 1e-6
        device_info["window_s"] = traced.window_s
        result["breakdown"] = {"device_ops": top_device_ops(traced), "idle_gaps": idle_gaps(traced)}
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.environ["DEODR_KERNEL_BUILD_DIR"] = str(KERNEL_BUILD_DIR)
    import torch

    spec = load_cell(Path.cwd(), args.workload)
    chips = int(spec.cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, device_count() is {torch.cuda.device_count()}", file=sys.stderr)
        return 1
    torch.set_num_threads(1)
    result = run_cell(spec, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0))
    found = forbidden_modules()
    if found:
        print(f"loaded during the run, which the benchmark forbids: {', '.join(found)}", file=sys.stderr)
        return 1
    for name, c in result["checks"].items():
        ok = "ok" if c["value"] <= c["limit"] else "FAILS"
        print(f"check {name} = {c['value']!r} limit {c['limit']!r} {ok}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    if str(CHECKOUT) not in sys.path:
        sys.path.insert(0, str(CHECKOUT))
    sys.exit(main())
