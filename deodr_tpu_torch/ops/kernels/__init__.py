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

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
SOURCES = ("raster_kernel.cu", "edge_kernel.cu", "edge_tex_kernel.cu", "quad_blend_kernel.cu")

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
    # setup, affine, counts, n_tiles, n_tx, tile_h, tile_w, cap, d, strict, persp, threads, blocks_per_tile,
    # smem_bytes, slot_map, z, vals, stream
    "raster_fwd": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P),
    # slot_map, g_vals, counts, n_tiles, n_tx, tile_h, tile_w, cap, d, threads, blocks_per_tile, g_table, stream
    "raster_bwd": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P),
    # table, counts, zbuf, obs, buf_in, n_tiles, n_tx, tile_h, tile_w, cap, C, err,
    # threads, blocks_per_tile, smem_bytes, buf_out, stream
    "edge_fwd": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P),
    # table, counts, zbuf, obs, buf_final, g_out, n_tiles, n_tx, tile_h, tile_w, cap, C, err,
    # threads, blocks_per_tile, pixels, smem_bytes, g_table, g_buf0, stream
    "edge_bwd": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P),
    # table, counts, zbuf, obs, texture, buf_in, n_tiles, n_tx, tile_h, tile_w, cap, C, err, tex_h, tex_w,
    # threads, blocks_per_tile, smem_bytes, buf_out, stream
    "edge_tex_fwd": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P),
    # table, counts, zbuf, obs, texture, buf_final, g_out, n_tiles, n_tx, tile_h, tile_w, cap, C, err,
    # tex_h, tex_w, threads, blocks_per_tile, pixels, smem_bytes, g_table, g_buf0, g_texture, stream
    "edge_tex_bwd": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P),
    # win, dv, du, ev, eu, n_quads, C, out, stream
    "quad_blend_fwd": (_P, _P, _P, _P, _P, _I, _I, _P, _P),
    # win, dv, du, ev, eu, ct, n_quads, C, d_win, d_ev, d_eu, stream
    "quad_blend_bwd": (_P, _P, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P),
}
# every kernel that can be launched is counted: the names are the entry points'
KERNEL_NAMES = tuple(_SIGNATURES)
LAUNCHES = {name: 0 for name in KERNEL_NAMES}
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


class WarpRegions(NamedTuple):
    """The warp regions of a tile, as ``Regions`` in csrc/common.cuh lays
    them out: a warp's lanes cover a 16 × 2 patch, each lane ``pixels``
    pixels in as many patches, rp rows × cp columns of them (rp the largest
    divisor of ``pixels`` that the tile's rows of patches hold); ``cols``
    regions a row of the tile, ``count`` in all."""

    rp: int
    cp: int
    cols: int
    count: int


def warp_regions(tile_h: int, tile_w: int, pixels: int) -> WarpRegions:
    cols, rows = -(-tile_w // 16), -(-tile_h // 2)
    rp = max((d for d in range(1, pixels + 1) if pixels % d == 0 and d <= rows), default=1)
    cp = pixels // rp
    return WarpRegions(rp, cp, -(-cols // cp), -(-cols // cp) * -(-rows // rp))


# the forward kernels' frame (csrc/common.cuh): rows walked per chunk (two
# chunks are staged) and threads per block
FWD_CHUNK = 64
FWD_THREADS = 256


class FwdShape(NamedTuple):
    """Launch shape of a forward kernel (``raster_fwd``, ``edge_fwd``,
    ``edge_tex_fwd``), all
    of it passed to the kernel's entry point: ``blocks_per_tile``
    independent blocks of ``threads`` threads a tile, a warp a region of
    the tile, and ``smem_bytes`` of shared memory for two chunks of table
    rows (the launcher refuses any other shape)."""

    threads: int
    blocks_per_tile: int
    smem_bytes: int


def fwd_launch_shape(tile_h: int, tile_w: int, pixels: int, row_width: int, itemsize: int) -> FwdShape:
    """256 threads a block (fewer on a tile of fewer warp regions) and as
    many blocks a tile as its regions need at the kernel's ``pixels`` a
    lane; shared memory for two chunks of 64 rows of ``row_width`` values
    (one walked while the next is copied in)."""
    warps = max(1, warp_regions(tile_h, tile_w, pixels).count)
    threads = min(FWD_THREADS, 32 * warps)
    return FwdShape(threads, -(-32 * warps // threads), 2 * FWD_CHUNK * row_width * itemsize)


def region_rects(grid: "TileGrid", pixels: int, dtype, device):
    """The rectangle of every warp region of every tile, as ``region_rect``
    in csrc/common.cuh gives it to a kernel's cull (not clipped to the
    tile) → x0, x1, y0, y1, each (n_tiles, regions)."""
    g = warp_regions(grid.tile_h, grid.tile_w, pixels)
    t = torch.arange(grid.n_tiles, device=device)[:, None]
    r = torch.arange(g.count, device=device)[None, :]
    x0 = (t % grid.n_tx) * grid.tile_w + (r % g.cols) * 16 * g.cp
    y0 = (t // grid.n_tx) * grid.tile_h + (r // g.cols) * 2 * g.rp
    x1, y1 = x0 + 16 * g.cp - 1, y0 + 2 * g.rp - 1
    return tuple(v.to(dtype) for v in (x0, x1, y0, y1))


def region_cull(may_cover, table_tile, counts, grid: "TileGrid", pixels: int) -> torch.Tensor:
    """(n_tiles, regions, cap) bool: the (warp region, slot) pairs that a
    forward kernel's cull keeps at ``pixels`` pixels a lane, given the plain
    mirror ``may_cover(rows, x0, x1, y0, y1)`` of its test; slots at or
    above a tile's count are not walked."""
    cap = table_tile.shape[1]
    x0, x1, y0, y1 = (v[:, :, None] for v in region_rects(grid, pixels, table_tile.dtype, table_tile.device))
    keep = may_cover(table_tile[:, None], x0, x1, y0, y1)
    used = torch.arange(cap, device=table_tile.device)[None, :] < counts.to(torch.int64).clamp(max=cap)[:, None]
    return keep & used[:, None, :]


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
