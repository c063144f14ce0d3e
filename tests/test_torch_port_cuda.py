"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Skipped where there is no CUDA card: the CPU tests hold the plain versions
against the JAX package. On a machine with one card, from the repository
root (``--noconftest`` because tests/conftest.py configures JAX, which the
port does not use)::

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_cuda.py

The first case runs chip_smoke.py's kernel and main-path phases of the
untextured path at a small size: slot_map exact, z within 1e-5, images
within 1e-4, gradient tables within 1e-3 of their scale, and every kernel
of that path launched. The second holds the textured edge kernel against
its plain version on the small mixed scene of the CPU tests, in float64 to
1e-9 of scale (only the order of the atomic sums differs) and in float32 to
chip_smoke.py's limits, then the whole textured ``render_scene`` with
``impl="kernel"`` against ``impl="reference"``.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernels_and_main_path_match_plain_versions(cuda_device, dtype):
    import chip_smoke
    from deodr_tpu_torch import scene_buffers_from_numpy, suggest_tiling
    from deodr_tpu_torch.bench_scene import bench_scene_fields
    from deodr_tpu_torch.ops import kernels

    height, width, n_tri = 144, 256, 40
    fields = bench_scene_fields(height, width, n_tri)
    scene = scene_buffers_from_numpy(fields, device=cuda_device, dtype=dtype)
    tiling = suggest_tiling(fields["ij"], fields["faces"], height, width, sigma=1.0, edgeflags=fields["edgeflags"],
                            margin=1.0, for_pallas=True, bucket_mode="exact")
    obs = torch.from_numpy(np.random.RandomState(3).rand(height, width, 3)).to(cuda_device, dtype)
    chip_smoke.check_kernels(scene, tiling, obs, cuda_device, print)
    kernels.reset_launches()
    chip_smoke.main_path(scene, tiling, obs, print)
    untextured = ("raster_fwd", "raster_bwd", "edge_fwd", "edge_bwd")
    assert all(kernels.LAUNCHES[name] > 0 for name in untextured), kernels.LAUNCHES


@pytest.mark.parametrize("error_mode", [False, True], ids=["image", "error"])
@pytest.mark.parametrize("plan", ["unsplit", "split", "clamped"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_edge_tex_kernel_matches_plain_version(cuda_device, dtype, plan, error_mode):
    import dataclasses

    import deodr_tpu_torch as port
    from deodr_tpu_torch.ops import kernels
    from deodr_tpu_torch.ops.kernels import edge_tex_kernel as etk
    from deodr_tpu_torch.ops.render import scene_buffers_from_numpy
    from torch_port_scenes import AA_EDGE_CAPACITY, SIGMA, TILING, obs_image, plan_scene, tex_tables

    tight = dtype == torch.float64
    lim_out, lim_grad = (1e-9, 1e-9) if tight else (1e-4, 1e-3)

    def rel(a, b):
        return float((a - b).abs().max()) / max(float(b.abs().max()), 1.0)

    et, texture, buf, z_pad, obs_pad = tex_tables(plan, error_mode, dtype, cuda_device)
    args = (et.table_tile, texture, buf, z_pad, obs_pad, et.counts, et.grid, error_mode)
    kernels.reset_launches()
    out_k = etk.edge_tex_fwd(*args)
    out_r = etk.edge_tex_fwd(*args, impl="reference")
    assert float((out_k - out_r).abs().max()) <= lim_out
    g_out = torch.from_numpy(np.random.RandomState(6).randn(*out_r.shape)).to(cuda_device, dtype)
    bargs = (et.table_tile, texture, out_r, z_pad, obs_pad, g_out, et.counts, et.grid, error_mode)
    got = etk.edge_tex_bwd(*bargs)
    want = etk.edge_tex_bwd(*bargs, impl="reference")
    torch.cuda.synchronize()
    for name, a, b in zip(("g_rows", "g_buf0", "g_texture"), got, want):
        assert float(b.abs().max()) > 0, name
        assert rel(a, b) <= lim_grad, name
    assert kernels.LAUNCHES["edge_tex_fwd"] == 1 and kernels.LAUNCHES["edge_tex_bwd"] == 1

    # the whole textured render: kernels against plain versions
    fields, kw = plan_scene(plan)
    scene = scene_buffers_from_numpy(fields, device=cuda_device, dtype=dtype)
    obs = torch.from_numpy(obs_image()).to(cuda_device, dtype)
    names = ("ij", "colors", "uv", "shade", "texture")
    results = {}
    for impl in ("kernel", "reference"):
        leaves = {k: getattr(scene, k).clone().requires_grad_(True) for k in names}
        img, _, err = port.render_scene(
            dataclasses.replace(scene, **leaves), SIGMA, antialiase_error=error_mode, obs=obs,
            aa_edge_capacity=AA_EDGE_CAPACITY, tiling=port.TilingConfig(**TILING), aa_tex_plan=port.EdgeTexPlan(**kw),
            impl=impl, check_capacity=True,
        )
        out = err if error_mode else img
        grads = torch.autograd.grad((out * torch.cos(torch.arange(out.numel(), device=cuda_device).reshape(out.shape))).sum(),
                                    [leaves[k] for k in names])
        results[impl] = (out.detach(), dict(zip(names, grads)))
    assert float((results["kernel"][0] - results["reference"][0]).abs().max()) <= lim_out
    for k in names:
        assert rel(results["kernel"][1][k], results["reference"][1][k]) <= lim_grad, k
