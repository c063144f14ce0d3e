"""Benchmark of ``deodr_tpu_torch``, the PyTorch / CUDA rasterizer.

One command runs one cell (a configuration under a traffic mix) once and
prints one JSON line::

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

``BENCHMARK.json`` at the repository root lists the cells and metrics.
Everything that belongs to one configuration, traffic mix, per-layer
metric or hand kernel is a file of its own, found by name:
``configs/<config>.json``, ``traffic/<traffic>.json``,
``metrics/<metric>.py``, ``kernels/<kernel>.json`` and
``limits/<cell>.json`` (the limits of the comparison that decides
``correct``). The plain reference (``reference.py``) imports nothing of
the port; nothing here imports JAX or the JAX package.
"""
