"""Build, load and count the hand-written CUDA kernels.

The kernels live in ``deodr_tpu_torch/csrc/*.cu`` with a plain C interface.
At first use on the card they are compiled with ``nvcc`` (one process per
source, all started together, then one link) into a shared library under
``BUILD_DIR`` (``build/kernels/`` at the repository root in a checkout),
named by a hash of the sources and flags, and loaded with :mod:`ctypes`. Nothing here runs at import time:
the CPU tests import every module on a machine with no ``nvcc``.

``LAUNCHES`` counts kernel launches per kernel name. A wrapper adds one
where it launches its kernel and nowhere else, so a run can show that the
main path went through the kernels and not through their plain versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import NamedTuple

import torch

KERNEL_NAMES = ("raster_fwd", "raster_bwd", "edge_fwd", "edge_bwd")
LAUNCHES = {name: 0 for name in KERNEL_NAMES}

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
SOURCES = ("raster_kernel.cu", "edge_kernel.cu")

# In a source checkout the library goes to build/kernels/ beside the package;
# an installed copy builds under the user's cache instead of site-packages.
# DEODR_KERNEL_BUILD_DIR overrides both.
if os.environ.get("DEODR_KERNEL_BUILD_DIR"):
    BUILD_DIR = Path(os.environ["DEODR_KERNEL_BUILD_DIR"])
elif (_PKG.parent / "pyproject.toml").exists():
    BUILD_DIR = _PKG.parent / "build" / "kernels"
else:
    BUILD_DIR = Path(os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache") / "deodr_tpu_torch" / "kernels"
# -fmad=false: the coverage, band and z-test planes must round exactly as
# the plain PyTorch versions do (one rounding per multiply and per add), or
# pixels within an ulp of an edge land on different sides
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-fmad=false",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: name → argument types (all return cudaError_t as int)
_SIGNATURES = {
    # setup, affine, counts, n_tiles, n_tx, tile_h, tile_w, cap, d, slot_map, z, vals, stream
    "raster_fwd": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P),
    # slot_map, g_vals, counts, n_tiles, n_tx, tile_h, tile_w, cap, d, g_table, stream
    "raster_bwd": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P),
    # table, counts, zbuf, obs, buf_in, n_tiles, n_tx, tile_h, tile_w, cap, C, err, buf_out, stream
    "edge_fwd": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P),
    # table, counts, zbuf, obs, buf_final, g_out, n_tiles, n_tx, tile_h, tile_w, cap, C, err,
    # g_table, g_buf0, stream
    "edge_bwd": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P),
}
_DTYPE_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}

_lib = None


def reset_launches() -> None:
    for name in KERNEL_NAMES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    found = shutil.which("nvcc") or str(Path(cuda_home) / "bin" / "nvcc")
    if not Path(found).exists():
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")
    return found


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode() + src.read_bytes())
    return BUILD_DIR / f"libdeodr_kernels-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels if the library for these sources is missing;
    returns its path. Objects compile in parallel into a temporary
    directory, and the finished library is moved into place atomically so
    two processes building at once never load a half-written file."""
    out = _library_path()
    if out.exists():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (Path(src).stem + ".o") for src in SOURCES]
        procs = [
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(CSRC / src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for src, obj in zip(SOURCES, objs)
        ]
        logs = [p.communicate()[0] for p in procs]
        for src, p, log in zip(SOURCES, procs, logs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src}:\n{log}")
        tmp_lib = Path(tmp) / out.name
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", *map(str, objs), "-o", str(tmp_lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_lib, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            for suffix in _DTYPE_SUFFIX.values():
                fn = getattr(lib, f"{name}_{suffix}")
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
        lib.deodr_error_string.argtypes = [ctypes.c_int]
        lib.deodr_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def launch(name: str, dtype: torch.dtype, *args) -> None:
    """Call C entry ``name`` for ``dtype`` on the current stream, raise on
    a CUDA error, and count the launch."""
    lib = library()
    fn = getattr(lib, f"{name}_{_DTYPE_SUFFIX[dtype]}")
    rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel failed: {lib.deodr_error_string(rc).decode()}")
    LAUNCHES[name] += 1


def check_tensor(t: torch.Tensor, name: str, dtype, shape) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype``/``shape``."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def check_float(t: torch.Tensor, name: str) -> None:
    if t.dtype not in _DTYPE_SUFFIX:
        raise ValueError(f"{name}: the kernels take float32 or float64, got {t.dtype}")


def use_kernel(t: torch.Tensor, impl: str) -> bool:
    """True where the wrapper must launch its kernel: a CUDA tensor and
    ``impl == "kernel"``. CPU tensors, or ``impl == "reference"``, take the
    plain PyTorch version; any other device raises."""
    if impl not in ("kernel", "reference"):
        raise ValueError(f"impl must be 'kernel' or 'reference', got {impl!r}")
    if t.device.type == "cpu" or impl == "reference":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"no kernel for device {t.device}")
    return True


class TileGrid(NamedTuple):
    """The framebuffer split into n_ty × n_tx tiles of tile_h × tile_w
    pixels; padded planes are (n_ty·tile_h, n_tx·tile_w), tile t is row
    t // n_tx, column t % n_tx."""

    n_ty: int
    n_tx: int
    tile_h: int
    tile_w: int

    @property
    def n_tiles(self) -> int:
        return self.n_ty * self.n_tx

    @property
    def padded_hw(self):
        return self.n_ty * self.tile_h, self.n_tx * self.tile_w


def tile_coords(grid: TileGrid, dtype, device):
    """Global pixel coordinates per tile: y (n_tiles, th, 1), x (n_tiles, 1, tw)."""
    t = torch.arange(grid.n_tiles, device=device)
    yy = (t // grid.n_tx)[:, None, None] * grid.tile_h + torch.arange(grid.tile_h, device=device)[None, :, None]
    xx = (t % grid.n_tx)[:, None, None] * grid.tile_w + torch.arange(grid.tile_w, device=device)[None, None, :]
    return yy.to(dtype), xx.to(dtype)


def to_tiles(a: torch.Tensor, grid: TileGrid) -> torch.Tensor:
    """(..., H', W') padded planes → (n_tiles, ..., th, tw)."""
    lead = a.shape[:-2]
    a = a.reshape(lead + (grid.n_ty, grid.tile_h, grid.n_tx, grid.tile_w))
    k = len(lead)
    a = a.permute((k, k + 2) + tuple(range(k)) + (k + 1, k + 3))
    return a.reshape((grid.n_tiles,) + lead + (grid.tile_h, grid.tile_w))


def from_tiles(a: torch.Tensor, grid: TileGrid) -> torch.Tensor:
    """Inverse of :func:`to_tiles`: (n_tiles, ..., th, tw) → (..., H', W')."""
    lead = a.shape[1:-2]
    k = len(lead)
    a = a.reshape((grid.n_ty, grid.n_tx) + lead + (grid.tile_h, grid.tile_w))
    a = a.permute(tuple(range(2, 2 + k)) + (0, 2 + k, 1, 3 + k))
    return a.reshape(lead + grid.padded_hw)
