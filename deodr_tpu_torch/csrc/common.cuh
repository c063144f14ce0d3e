// Shared helpers of the tiled rasterizer kernels.
#pragma once

#include <cuda_runtime.h>

#include <cfloat>
#include <cmath>

namespace deodr {

constexpr int kThreads = 256;  // one thread per pixel, 8 warps per block
constexpr unsigned kFullMask = 0xffffffffu;

template <typename T>
struct Limits;
template <>
struct Limits<float> {
  static __device__ __forceinline__ float tiny() { return FLT_MIN; }
};
template <>
struct Limits<double> {
  static __device__ __forceinline__ double tiny() { return DBL_MIN; }
};

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFullMask, v, off);
  return v;
}

// Pixel owned by this thread: tile blockIdx.x, pixel blockIdx.y·256 + tid.
struct Pixel {
  bool inside;    // inside the tile (the last block of a tile may overhang)
  size_t offset;  // index into an (H', W') plane
  int x, y;       // global pixel coordinates
};

__device__ __forceinline__ Pixel pixel_of(int tile, int n_tx, int tile_h, int tile_w) {
  Pixel p;
  const int local = blockIdx.y * blockDim.x + threadIdx.x;
  p.inside = local < tile_h * tile_w;
  const int ty = tile / n_tx, tx = tile % n_tx;
  p.y = ty * tile_h + (p.inside ? local / tile_w : 0);
  p.x = tx * tile_w + (p.inside ? local % tile_w : 0);
  p.offset = (size_t)p.y * (size_t)(n_tx * tile_w) + (size_t)p.x;
  return p;
}

// Allow more than 48 KB of dynamic shared memory where a launch needs it.
template <typename K>
cudaError_t reserve_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace deodr
