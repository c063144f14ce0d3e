"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Skipped where there is no CUDA card: the CPU tests hold the plain versions
against the JAX package. On a machine with one card, from the repository
root (``--noconftest`` because tests/conftest.py configures JAX, which the
port does not use)::

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_cuda.py

Each case runs chip_smoke.py's kernel and main-path phases at a small size:
slot_map exact, z within 1e-5, images within 1e-4, gradient tables within
1e-3 of their scale, and every kernel launched on the main path.
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
    assert all(kernels.LAUNCHES[name] > 0 for name in kernels.KERNEL_NAMES), kernels.LAUNCHES
