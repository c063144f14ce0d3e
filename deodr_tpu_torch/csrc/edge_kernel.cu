// Tiled silhouette edge-overdraw pass (untextured): forward painter's blend
// over the binned edge slots and backward reverse loop with un-blending.
//
// Replaces deodr_tpu/ops/pallas/edge_kernel.py: _fwd_kernel (called by
// _edge_fwd_call) and _bwd_kernel (called by _edge_bwd).
//
// What bounds it on the H100. Each pixel visits every edge band binned to
// its tile: ~40 float operations per visit in image mode with C = 3 (four
// band planes, y range, depth plane, transparency plane, C colour planes
// and the blend), more in the backward (the un-blend divides once per
// visit and three moments per gradient quantity are reduced). Bytes are a
// handful of planes per pixel (buffer in and out, z-buffer, observation in
// error mode). At the bench scene that makes it bound by operations, as the
// solid pass is. The backward adds a reduction across the pixels of a tile
// for every slot, which on a GPU means cross-thread sums and atomics.
//
// What this first design does. One thread per pixel, a block of 256 pixels
// of one tile; the tile's edge rows are staged in shared memory 32 slots at
// a time and every thread walks them in painter's order, keeping its C
// colour planes (or its one residual plane) in registers. The backward
// walks the same chunks from the last slot down, rebuilds the pre-blend
// value as (buf − A)·(1/T) + A with |T| floored at 1e-6, reduces each
// slot's 3·(1 + C) moments across the warp with shuffles (skipped when no
// pixel of the warp is in the band), then across the block in shared
// memory, and issues one global atomic per block and table entry. The sum
// order differs from the TPU's, so gradient tables agree to float32
// rounding of the sums, not bit for bit. Compiled with -fmad=false: the
// band, y-range and z-test planes round exactly as the plain PyTorch
// version's, so both select the same pixels.

#include "common.cuh"

namespace deodr {

constexpr int kEdgeChunk = 32;  // edge rows staged in shared memory at a time
constexpr double kTDivEps = 1e-6;

template <typename T>
__device__ __forceinline__ T plane3(const T* c, T x, T y) {
  return c[0] * x + (c[1] * y + c[2]);
}

// Blend mask and transparency of one edge row at pixel (x, y); row layout
// in edge_kernel.py. T is 0.5 where the mask is off, as on the TPU.
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

template <typename T, int C, bool kErr>
__global__ void __launch_bounds__(kThreads)
    edge_fwd_kernel(const T* __restrict__ table, const int* __restrict__ counts, const T* __restrict__ zbuf,
                    const T* __restrict__ obs, const T* __restrict__ buf_in, int n_tx, int tile_h, int tile_w, int cap,
                    T* __restrict__ buf_out) {
  constexpr int W = 25 + 3 * C;
  constexpr int NCH = kErr ? 1 : C;
  __shared__ T rows[kEdgeChunk * W];
  const int tile = blockIdx.x;
  const Pixel px = pixel_of(tile, n_tx, tile_h, tile_w);
  const size_t plane = (size_t)gridDim.x * tile_h * tile_w;
  const T x = (T)px.x, y = (T)px.y;
  const int count = min(counts[tile], cap);

  T buf[NCH], ob[C];
  T zb = (T)0;
#pragma unroll
  for (int ch = 0; ch < NCH; ++ch) buf[ch] = px.inside ? buf_in[ch * plane + px.offset] : (T)0;
#pragma unroll
  for (int ch = 0; ch < C; ++ch) ob[ch] = (kErr && px.inside) ? obs[ch * plane + px.offset] : (T)0;
  if (px.inside) zb = zbuf[px.offset];

  const T* tile_rows = table + (size_t)tile * cap * W;
  for (int base = 0; base < count; base += kEdgeChunk) {
    const int n = min(kEdgeChunk, count - base);
    __syncthreads();
    for (int i = threadIdx.x; i < n * W; i += blockDim.x) rows[i] = tile_rows[(size_t)base * W + i];
    __syncthreads();
    if (!px.inside) continue;
    for (int k = 0; k < n; ++k) {
      const T* r = rows + k * W;
      T t;
      if (!band_mask<T, C>(r, x, y, zb, t)) continue;
      if constexpr (kErr) {
        T err = (T)0;
#pragma unroll
        for (int ch = 0; ch < C; ++ch) {
          const T diff = plane3(r + 21 + 3 * ch, x, y) - ob[ch];
          err = err + diff * diff;
        }
        buf[0] = err + t * (buf[0] - err);
      } else {
#pragma unroll
        for (int ch = 0; ch < NCH; ++ch) {
          const T a = plane3(r + 21 + 3 * ch, x, y);
          buf[ch] = a + t * (buf[ch] - a);
        }
      }
    }
  }
  if (!px.inside) return;
#pragma unroll
  for (int ch = 0; ch < NCH; ++ch) buf_out[ch * plane + px.offset] = buf[ch];
}

template <typename T, int C, bool kErr>
__global__ void __launch_bounds__(kThreads)
    edge_bwd_kernel(const T* __restrict__ table, const int* __restrict__ counts, const T* __restrict__ zbuf,
                    const T* __restrict__ obs, const T* __restrict__ buf_final, const T* __restrict__ g_out, int n_tx,
                    int tile_h, int tile_w, int cap, T* __restrict__ g_rows, T* __restrict__ g_buf0) {
  constexpr int W = 25 + 3 * C;
  constexpr int GW = 3 + 3 * C;
  constexpr int NQ = 1 + C;  // gradient quantities: t, then one colour row per channel
  constexpr int NCH = kErr ? 1 : C;
  __shared__ T rows[kEdgeChunk * W];
  __shared__ T acc[kEdgeChunk * GW];
  const int tile = blockIdx.x;
  const Pixel px = pixel_of(tile, n_tx, tile_h, tile_w);
  const size_t plane = (size_t)gridDim.x * tile_h * tile_w;
  const T x = (T)px.x, y = (T)px.y;
  const int count = min(counts[tile], cap);
  const int lane = threadIdx.x & 31;
  const T eps = (T)kTDivEps;

  T buf[NCH], gb[NCH], ob[C];
  T zb = (T)0;
#pragma unroll
  for (int ch = 0; ch < NCH; ++ch) {
    buf[ch] = px.inside ? buf_final[ch * plane + px.offset] : (T)0;
    gb[ch] = px.inside ? g_out[ch * plane + px.offset] : (T)0;
  }
#pragma unroll
  for (int ch = 0; ch < C; ++ch) ob[ch] = (kErr && px.inside) ? obs[ch * plane + px.offset] : (T)0;
  if (px.inside) zb = zbuf[px.offset];

  const T* tile_rows = table + (size_t)tile * cap * W;
  T* tile_grads = g_rows + (size_t)tile * cap * GW;
  for (int hi = count; hi > 0; hi -= kEdgeChunk) {
    const int lo = max(0, hi - kEdgeChunk);
    const int n = hi - lo;
    __syncthreads();
    for (int i = threadIdx.x; i < n * W; i += blockDim.x) rows[i] = tile_rows[(size_t)lo * W + i];
    for (int i = threadIdx.x; i < n * GW; i += blockDim.x) acc[i] = (T)0;
    __syncthreads();
    for (int k = n - 1; k >= 0; --k) {
      const T* r = rows + k * W;
      T t = (T)0.5;
      const bool mask = px.inside && band_mask<T, C>(r, x, y, zb, t);
      T q[NQ];
#pragma unroll
      for (int i = 0; i < NQ; ++i) q[i] = (T)0;
      if (mask) {
        const T td = fabs(t) < eps ? (t < (T)0 ? -eps : eps) : t;
        const T rt = (T)1 / td;
        const T one_minus_t = (T)1 - t;
        T a[C];
#pragma unroll
        for (int ch = 0; ch < C; ++ch) a[ch] = plane3(r + 21 + 3 * ch, x, y);
        if constexpr (kErr) {
          T err = (T)0;
#pragma unroll
          for (int ch = 0; ch < C; ++ch) {
            const T diff = a[ch] - ob[ch];
            err = err + diff * diff;
          }
          const T before = (buf[0] - err) * rt + err;
          const T g_o = gb[0];
          q[0] = g_o * (before - err);
          const T g_err = g_o * one_minus_t;
#pragma unroll
          for (int ch = 0; ch < C; ++ch) q[1 + ch] = g_err * (T)2 * (a[ch] - ob[ch]);
          buf[0] = before;
          gb[0] = t * g_o;
        } else {
          T g_t = (T)0;
#pragma unroll
          for (int ch = 0; ch < NCH; ++ch) {
            const T before = (buf[ch] - a[ch]) * rt + a[ch];
            const T g_o = gb[ch];
            g_t = g_t + g_o * (before - a[ch]);
            q[1 + ch] = g_o * one_minus_t;
            buf[ch] = before;
            gb[ch] = t * g_o;
          }
          q[0] = g_t;
        }
      }
      if (__any_sync(kFullMask, mask)) {
#pragma unroll
        for (int i = 0; i < NQ; ++i) {
          const T sx = warp_sum(q[i] * x);
          const T sy = warp_sum(q[i] * y);
          const T sc = warp_sum(q[i]);
          if (lane == 0) {
            atomicAdd(&acc[k * GW + 3 * i], sx);
            atomicAdd(&acc[k * GW + 3 * i + 1], sy);
            atomicAdd(&acc[k * GW + 3 * i + 2], sc);
          }
        }
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < n * GW; i += blockDim.x) {
      const T v = acc[i];
      if (v != (T)0) atomicAdd(&tile_grads[(size_t)lo * GW + i], v);
    }
  }
  if (!px.inside) return;
#pragma unroll
  for (int ch = 0; ch < NCH; ++ch) g_buf0[ch * plane + px.offset] = gb[ch];
}

template <typename T, int C>
static void edge_fwd_c(bool err, dim3 grid, cudaStream_t s, const T* table, const int* counts, const T* zbuf,
                       const T* obs, const T* buf_in, int n_tx, int tile_h, int tile_w, int cap, T* buf_out) {
  if (err)
    edge_fwd_kernel<T, C, true><<<grid, kThreads, 0, s>>>(table, counts, zbuf, obs, buf_in, n_tx, tile_h, tile_w,
                                                           cap, buf_out);
  else
    edge_fwd_kernel<T, C, false><<<grid, kThreads, 0, s>>>(table, counts, zbuf, obs, buf_in, n_tx, tile_h, tile_w,
                                                            cap, buf_out);
}

template <typename T, int C>
static void edge_bwd_c(bool err, dim3 grid, cudaStream_t s, const T* table, const int* counts, const T* zbuf,
                       const T* obs, const T* buf_final, const T* g_out, int n_tx, int tile_h, int tile_w, int cap,
                       T* g_rows, T* g_buf0) {
  if (err)
    edge_bwd_kernel<T, C, true><<<grid, kThreads, 0, s>>>(table, counts, zbuf, obs, buf_final, g_out, n_tx, tile_h,
                                                           tile_w, cap, g_rows, g_buf0);
  else
    edge_bwd_kernel<T, C, false><<<grid, kThreads, 0, s>>>(table, counts, zbuf, obs, buf_final, g_out, n_tx, tile_h,
                                                            tile_w, cap, g_rows, g_buf0);
}

template <typename T>
static int edge_fwd_launch(const void* table, const void* counts, const void* zbuf, const void* obs,
                           const void* buf_in, int n_tiles, int n_tx, int tile_h, int tile_w, int cap, int c, int err,
                           void* buf_out, void* stream) {
  const int n_px = tile_h * tile_w;
  if (n_tiles == 0 || n_px == 0) return 0;
  const dim3 grid(n_tiles, (n_px + kThreads - 1) / kThreads);
  const cudaStream_t s = (cudaStream_t)stream;
  auto args = [&](auto launch) {
    launch(err != 0, grid, s, (const T*)table, (const int*)counts, (const T*)zbuf, (const T*)obs, (const T*)buf_in,
           n_tx, tile_h, tile_w, cap, (T*)buf_out);
  };
  switch (c) {
    case 1: args(edge_fwd_c<T, 1>); break;
    case 2: args(edge_fwd_c<T, 2>); break;
    case 3: args(edge_fwd_c<T, 3>); break;
    case 4: args(edge_fwd_c<T, 4>); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename T>
static int edge_bwd_launch(const void* table, const void* counts, const void* zbuf, const void* obs,
                           const void* buf_final, const void* g_out, int n_tiles, int n_tx, int tile_h, int tile_w,
                           int cap, int c, int err, void* g_rows, void* g_buf0, void* stream) {
  const int n_px = tile_h * tile_w;
  if (n_tiles == 0 || n_px == 0) return 0;
  const dim3 grid(n_tiles, (n_px + kThreads - 1) / kThreads);
  const cudaStream_t s = (cudaStream_t)stream;
  auto args = [&](auto launch) {
    launch(err != 0, grid, s, (const T*)table, (const int*)counts, (const T*)zbuf, (const T*)obs,
           (const T*)buf_final, (const T*)g_out, n_tx, tile_h, tile_w, cap, (T*)g_rows, (T*)g_buf0);
  };
  switch (c) {
    case 1: args(edge_bwd_c<T, 1>); break;
    case 2: args(edge_bwd_c<T, 2>); break;
    case 3: args(edge_bwd_c<T, 3>); break;
    case 4: args(edge_bwd_c<T, 4>); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace deodr

extern "C" {

int edge_fwd_f32(const void* table, const void* counts, const void* zbuf, const void* obs, const void* buf_in,
                 int n_tiles, int n_tx, int tile_h, int tile_w, int cap, int c, int err, void* buf_out, void* stream) {
  return deodr::edge_fwd_launch<float>(table, counts, zbuf, obs, buf_in, n_tiles, n_tx, tile_h, tile_w, cap, c, err,
                                       buf_out, stream);
}

int edge_fwd_f64(const void* table, const void* counts, const void* zbuf, const void* obs, const void* buf_in,
                 int n_tiles, int n_tx, int tile_h, int tile_w, int cap, int c, int err, void* buf_out, void* stream) {
  return deodr::edge_fwd_launch<double>(table, counts, zbuf, obs, buf_in, n_tiles, n_tx, tile_h, tile_w, cap, c, err,
                                        buf_out, stream);
}

int edge_bwd_f32(const void* table, const void* counts, const void* zbuf, const void* obs, const void* buf_final,
                 const void* g_out, int n_tiles, int n_tx, int tile_h, int tile_w, int cap, int c, int err,
                 void* g_rows, void* g_buf0, void* stream) {
  return deodr::edge_bwd_launch<float>(table, counts, zbuf, obs, buf_final, g_out, n_tiles, n_tx, tile_h, tile_w,
                                       cap, c, err, g_rows, g_buf0, stream);
}

int edge_bwd_f64(const void* table, const void* counts, const void* zbuf, const void* obs, const void* buf_final,
                 const void* g_out, int n_tiles, int n_tx, int tile_h, int tile_w, int cap, int c, int err,
                 void* g_rows, void* g_buf0, void* stream) {
  return deodr::edge_bwd_launch<double>(table, counts, zbuf, obs, buf_final, g_out, n_tiles, n_tx, tile_h, tile_w,
                                        cap, c, err, g_rows, g_buf0, stream);
}

}  // extern "C"
