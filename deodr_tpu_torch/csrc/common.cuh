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

struct Pixel {
  bool inside;    // inside the tile (the last block of a tile may overhang)
  size_t offset;  // index into an (H', W') plane
  int x, y;       // global pixel coordinates
};

// Pixel `local` (row-major within the tile) of tile `tile`.
__device__ __forceinline__ Pixel pixel_at(int tile, int local, int n_tx, int tile_h, int tile_w) {
  Pixel p;
  p.inside = local < tile_h * tile_w;
  const int ty = tile / n_tx, tx = tile % n_tx;
  p.y = ty * tile_h + (p.inside ? local / tile_w : 0);
  p.x = tx * tile_w + (p.inside ? local % tile_w : 0);
  p.offset = (size_t)p.y * (size_t)(n_tx * tile_w) + (size_t)p.x;
  return p;
}

// Pixel owned by this thread: tile blockIdx.x, pixel blockIdx.y·256 + tid.
__device__ __forceinline__ Pixel pixel_of(int tile, int n_tx, int tile_h, int tile_w) {
  return pixel_at(tile, blockIdx.y * blockDim.x + threadIdx.x, n_tx, tile_h, tile_w);
}

// ---- shared by the edge-pass kernels (edge_kernel.cu, edge_tex_kernel.cu) ----

constexpr int kEdgeChunk = 32;  // edge rows staged in shared memory at a time
constexpr double kTDivEps = 1e-6;

// Affine plane c0·x + (c1·y + c2), in the plain PyTorch versions' operation order.
template <typename T>
__device__ __forceinline__ T plane3(const T* c, T x, T y) {
  return c[0] * x + (c[1] * y + c[2]);
}

// Blend mask and transparency of one edge row at pixel (x, y); row layout
// in edge_kernel.py (the textured row appends its columns after it). T is
// 0.5 where the mask is off, as on the TPU.
template <typename T, int C>
__device__ __forceinline__ bool band_mask(const T* r, T x, T y, T zb, T& t) {
  t = plane3(r + 16, x, y);
  bool cov = true;
#pragma unroll
  for (int i = 0; i < 4; ++i) cov = cov && (plane3(r + 3 * i, x, y) > r[12 + i]);
  cov = cov && y >= r[19] && y <= r[20];
  const T z = plane3(r + 21 + 3 * C, x, y);
  const bool mask = cov && (z < zb) && (r[24 + 3 * C] > (T)0.5) && isfinite(t);
  if (!mask) t = (T)0.5;
  return mask;
}

// One painter's step at a masked pixel with band colour a[C]: per channel
// buf ← a + t·(buf − a) in image mode; in error mode the one plane blends
// the squared residual Σ (a − ob)².
template <typename T, int C, bool kErr>
__device__ __forceinline__ void blend(const T* a, const T* ob, T t, T* buf) {
  if constexpr (kErr) {
    T err = (T)0;
#pragma unroll
    for (int ch = 0; ch < C; ++ch) {
      const T diff = a[ch] - ob[ch];
      err = err + diff * diff;
    }
    buf[0] = err + t * (buf[0] - err);
  } else {
#pragma unroll
    for (int ch = 0; ch < C; ++ch) buf[ch] = a[ch] + t * (buf[ch] - a[ch]);
  }
}

// The reverse of blend() at a masked pixel: rebuilds the pre-blend buf as
// (buf − a)·(1/T) + a with |T| floored at 1e-6, writes d loss / d a[ch] to
// g_a, scales the carried cotangent gb by t and returns d loss / d t.
template <typename T, int C, bool kErr>
__device__ __forceinline__ T unblend(const T* a, const T* ob, T t, T* buf, T* gb, T* g_a) {
  const T eps = (T)kTDivEps;
  const T td = fabs(t) < eps ? (t < (T)0 ? -eps : eps) : t;
  const T rt = (T)1 / td;
  const T one_minus_t = (T)1 - t;
  T g_t = (T)0;
  if constexpr (kErr) {
    T err = (T)0;
#pragma unroll
    for (int ch = 0; ch < C; ++ch) {
      const T diff = a[ch] - ob[ch];
      err = err + diff * diff;
    }
    const T before = (buf[0] - err) * rt + err;
    const T g_o = gb[0];
    g_t = g_o * (before - err);
    const T g_err = g_o * one_minus_t;
#pragma unroll
    for (int ch = 0; ch < C; ++ch) g_a[ch] = g_err * (T)2 * (a[ch] - ob[ch]);
    buf[0] = before;
    gb[0] = t * g_o;
  } else {
#pragma unroll
    for (int ch = 0; ch < C; ++ch) {
      const T before = (buf[ch] - a[ch]) * rt + a[ch];
      const T g_o = gb[ch];
      g_t = g_t + g_o * (before - a[ch]);
      g_a[ch] = g_o * one_minus_t;
      buf[ch] = before;
      gb[ch] = t * g_o;
    }
  }
  return g_t;
}

// Adds the warp's three moments of q, (Σ q·x, Σ q·y, Σ q), to acc[0..2] in
// shared memory. Every lane of the warp must call it.
template <typename T>
__device__ __forceinline__ void add_moments(T* acc, T q, T x, T y) {
  const T sx = warp_sum(q * x);
  const T sy = warp_sum(q * y);
  const T sc = warp_sum(q);
  if ((threadIdx.x & 31) == 0) {
    atomicAdd(&acc[0], sx);
    atomicAdd(&acc[1], sy);
    atomicAdd(&acc[2], sc);
  }
}

// Allow more than 48 KB of dynamic shared memory where a launch needs it.
template <typename K>
cudaError_t reserve_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace deodr
