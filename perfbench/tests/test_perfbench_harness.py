"""The harness on the CPU at a small size: cells, traffic and metrics come
from files found by name, the result line has the contract's keys, and
nothing the benchmark runs imports JAX or the JAX package."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from perfbench import roofline, run
from perfbench.tests.small import CHECKOUT, small_root

CELLS = ("sphere131k_2048_f64.adam_s1", "sphere131k_2048_f32.adam_s1")
RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def _cpu_run(root: Path, cell: str, trace: bool = False, seed: int = 2**31 + 7) -> dict:
    return run.run_cell(run.load_cell(root, cell), seed, 0.3, trace, torch.device("cpu"), log=lambda *a, **k: None)


def test_new_config_traffic_and_metric_are_found_by_name(tmp_path):
    root = small_root(tmp_path)
    data = root / "perfbench"
    config = json.loads((data / "configs" / "sphere131k_2048_f64.json").read_text())
    (data / "configs" / "sphere2k_96_f64.json").write_text(json.dumps({**config, "subdivisions": 2}))
    traffic = json.loads((data / "traffic" / "adam_s1.json").read_text())
    (data / "traffic" / "adam_fast.json").write_text(json.dumps({**traffic, "lr_vertices_per_extent": 1e-4}))
    (data / "metrics" / "steps_run.py").write_text("def read(ctx):\n    return float(ctx.n_steps)\n")
    limits = (data / "limits" / "sphere131k_2048_f64.adam_s1.json").read_text()
    (data / "limits" / "sphere2k_96_f64.adam_fast.json").write_text(limits)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "sphere2k_96_f64", "file": "perfbench/configs/sphere2k_96_f64.json"})
    bench["workloads"].append({"name": "sphere2k_96_f64.adam_fast", "config": "sphere2k_96_f64",
                               "traffic": "adam_fast", "chips": 1})
    bench["end_to_end"].append({"name": "steps_run", "unit": "steps", "workloads": ["sphere2k_96_f64.adam_fast"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    spec = run.load_cell(root, "sphere2k_96_f64.adam_fast")
    assert spec.config["subdivisions"] == 2 and spec.traffic["lr_vertices_per_extent"] == 1e-4
    result = _cpu_run(root, "sphere2k_96_f64.adam_fast")
    assert result["correct"]
    assert result["metrics"]["steps_run"] == {"value": float(result["attempted"]), "unit": "steps"}
    assert "steps_run" not in _cpu_run(root, CELLS[0])["metrics"]


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_has_the_contract_keys(tmp_path, trace):
    result = _cpu_run(small_root(tmp_path), CELLS[1], trace)
    keys = RESULT_KEYS[:-1] + (["breakdown"] if trace else []) + ["checks"]
    assert list(result) == keys  # the numbers compared come last
    assert set(result["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if trace:
        assert set(result["device"]) >= {"busy_s", "window_s"}
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    for check in result["checks"].values():
        assert set(check) == {"value", "limit"}
    line = json.loads(json.dumps(result))
    assert line == result


def test_command_without_a_card_exits_nonzero_and_prints_no_result():
    proc = subprocess.run([sys.executable, "perfbench/run.py", "--workload", CELLS[0], "--seed", str(2**31 + 3),
                           "--seconds", "1", "--trace", "0"], cwd=CHECKOUT, capture_output=True, text=True,
                          timeout=120)
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_nothing_imports_jax_or_the_jax_package():
    files = sorted((CHECKOUT / "perfbench").rglob("*.py"))
    assert files
    for f in files:
        assert not _imports(f) & set(run.FORBIDDEN), f


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "deodr_tpu_torch_probe", sys)
    assert "deodr_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "deodr_tpu.probe", sys)
    assert "deodr_tpu" in run.forbidden_modules()


def test_reference_imports_nothing_of_the_port():
    for name in ("reference.py", "inputs.py", "compare.py", "roofline.py"):
        assert not _imports(CHECKOUT / "perfbench" / name) & {"deodr_tpu_torch", "deodr_tpu", "jax"}, name
    code = ("import sys; import perfbench.reference, perfbench.compare, perfbench.inputs, perfbench.roofline; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & {'deodr_tpu_torch', 'deodr_tpu', 'jax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=CHECKOUT, capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == "[]", out.stderr


def test_roofline_work_is_the_scenes_whatever_the_tiling(tmp_path, monkeypatch):
    """Two tilings of one scene (the planner's solid tile heights swapped),
    one work count: it reads the scene's sizes and nothing of the plan."""
    import deodr_tpu_torch.scene as port_scene
    from perfbench.fit import Fit
    from perfbench.inputs import make_inputs

    spec = run.load_cell(small_root(tmp_path, 4, 128), CELLS[0])
    inputs = make_inputs(spec.config, spec.traffic, 5, torch.device("cpu"))

    def work_and_tiling():
        fit = Fit(inputs, spec.traffic, torch.device("cpu"))
        fit.render()
        tiling = next(reversed(fit.scene._scene._last_plan.values()))[1]
        sizes = roofline.scene_sizes(run.reference_scene(inputs), inputs.vertices, 3)
        return roofline.step_work(sizes, inputs.vertices.element_size()), tiling

    work_a, tiling_a = work_and_tiling()
    monkeypatch.setattr(port_scene, "_tile_heights", lambda height: (32, 32))
    work_b, tiling_b = work_and_tiling()
    assert tiling_a.tile_h != tiling_b.tile_h
    assert work_a == work_b
    assert work_a["bytes"] > 2 * 3 * 8 * 0.5 * 128 * 128 * 0.3  # the covered pixels, written and read once
