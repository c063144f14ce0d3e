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
// The forward (first design). One thread per pixel, a block of 256 pixels
// of one tile; the tile's edge rows are staged in shared memory 32 slots at
// a time and every thread walks them in painter's order, keeping its C
// colour planes (or its one residual plane) in registers.
//
// The backward. Its first design had the forward's grid and reduced each
// slot's 3·(1 + C) moments inside the slot loop with 5 shuffles per value
// and contended shared atomics, then added every block's partials into a
// zero-filled table with global atomics: 0.0609 ms on the bench (NVIDIA
// H100 80GB HBM3, 700 W), 14× its bound. Measured by clamping every tile's
// slot count (build-free scans on the card), its time was the band test of
// every pixel against every slot, not the reduction. This design (the frame
// in common.cuh, shared with edge_tex_kernel.cu): a tile's blocks form one
// thread-block cluster (as few as cover the tile, at most 8 of 256
// threads); a warp owns a region of 16 × 2 patches, a lane up to 3 pixels;
// rows are staged 64 at a time and each warp first tests all of a chunk's
// slots against its region's rectangle at once (exact: a band that fails
// there fails every pixel; about 8 % pass on the bench), then walks only
// those in reverse painter's order, rebuilding the pre-blend value as
// (buf − A)·(1/T) + A with |T| floored at 1e-6. A lane sums its pixels'
// moments in registers, the warp reduces them with one reduce-scatter
// butterfly into its own shared row, the block sums its warps in order and
// the cluster its blocks in rank order through distributed shared memory,
// writing whole rows (rows ≥ count as 0): no atomics, no memset, the same
// table bits on every call. Compiled with -fmad=false: the band, y-range and
// z-test planes round exactly as the plain PyTorch version's, so both select
// the same pixels.

#include "common.cuh"

namespace deodr {

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
      T a[C];
#pragma unroll
      for (int ch = 0; ch < C; ++ch) a[ch] = plane3(r + 21 + 3 * ch, x, y);
      blend<T, C, kErr>(a, ob, t, buf);
    }
  }
  if (!px.inside) return;
#pragma unroll
  for (int ch = 0; ch < NCH; ++ch) buf_out[ch * plane + px.offset] = buf[ch];
}

// Pixels a lane of the backward kernel holds at most (edge_bwd_launch_shape
// picks how many); a tile with more pixels than its cluster can hold takes
// several passes over its slots.
constexpr int kBwdPixels = 3;

template <typename T, int C, bool kErr>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 4 ? 3 : 1)
    edge_bwd_kernel(const T* __restrict__ table, const int* __restrict__ counts, const T* __restrict__ zbuf,
                    const T* __restrict__ obs, const T* __restrict__ buf_final, const T* __restrict__ g_out, int n_tx,
                    int tile_h, int tile_w, int cap, int pixels, T* __restrict__ g_rows, T* __restrict__ g_buf0) {
  constexpr int W = 25 + 3 * C;
  constexpr int GW = 3 + 3 * C;  // moments of t, then of one colour plane per channel: 3·NQ
  constexpr int NQ = 1 + C;
  using Px = BwdPixels<T, C, kErr, kBwdPixels>;
  // painter's order, reversed, over the slots whose band may cover the region; all of a lane's pixels per slot
  auto walk = [](const T* rows, unsigned long long cover, Px& px, T* warp_acc) {
    for (int k = pop_highest(cover); k >= 0; k = pop_highest(cover)) {
      const T* r = rows + k * W;
      T v[kMoments];
#pragma unroll
      for (int i = 0; i < kMoments; ++i) v[i] = (T)0;
      bool any = false;
#pragma unroll
      for (int j = 0; j < kBwdPixels; ++j) {
        T t;
        if (!px.in(j) || !band_mask<T, C>(r, px.x[j], px.y[j], px.zb[j], t)) continue;
        any = true;
        T a[C], q[NQ];  // band colour; per-pixel cotangents of t and of the C colour planes
#pragma unroll
        for (int ch = 0; ch < C; ++ch) a[ch] = plane3(r + 21 + 3 * ch, px.x[j], px.y[j]);
        q[0] = unblend<T, C, kErr>(a, px.ob[j], t, px.buf[j], px.gb[j], q + 1);
#pragma unroll
        for (int i = 0; i < NQ; ++i) add_moments(v + 3 * i, q[i], px.x[j], px.y[j]);
      }
      store_warp_moments(warp_acc, k, any, v);
    }
  };
  edge_bwd_frame<T, C, kErr, kBwdPixels, W, GW>(table, counts, zbuf, obs, buf_final, g_out, n_tx, tile_h, tile_w,
                                                cap, pixels, g_rows, g_buf0, walk,
                                                [](const T*, int col) { return col; });
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
static cudaError_t edge_bwd_c(bool err, int n_tiles, int threads, int blocks_per_tile, int pixels, size_t smem_bytes,
                              cudaStream_t s, const T* table, const int* counts, const T* zbuf, const T* obs,
                              const T* buf_final, const T* g_out, int n_tx, int tile_h, int tile_w, int cap, T* g_rows,
                              T* g_buf0) {
  if (pixels < 1 || pixels > kBwdPixels) return cudaErrorInvalidValue;
  if (smem_bytes != edge_bwd_smem_elems(25 + 3 * C, 3 + 3 * C, threads / 32) * sizeof(T))
    return cudaErrorInvalidValue;
  auto go = [&](auto kernel) {
    return launch_tile_clusters(kernel, n_tiles, threads, blocks_per_tile, smem_bytes, s, table, counts, zbuf, obs,
                                buf_final, g_out, n_tx, tile_h, tile_w, cap, pixels, g_rows, g_buf0);
  };
  return err ? go(edge_bwd_kernel<T, C, true>) : go(edge_bwd_kernel<T, C, false>);
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
                           int cap, int c, int err, int threads, int blocks_per_tile, int pixels, int smem_bytes,
                           void* g_rows, void* g_buf0, void* stream) {
  if (n_tiles == 0) return 0;  // a tile without pixels still gets its zero rows
  const cudaStream_t s = (cudaStream_t)stream;
  auto args = [&](auto launch) {
    return (int)launch(err != 0, n_tiles, threads, blocks_per_tile, pixels, (size_t)smem_bytes, s, (const T*)table,
                       (const int*)counts, (const T*)zbuf, (const T*)obs, (const T*)buf_final, (const T*)g_out, n_tx,
                       tile_h, tile_w, cap, (T*)g_rows, (T*)g_buf0);
  };
  switch (c) {
    case 1: return args(edge_bwd_c<T, 1>);
    case 2: return args(edge_bwd_c<T, 2>);
    case 3: return args(edge_bwd_c<T, 3>);
    case 4: return args(edge_bwd_c<T, 4>);
    default: return (int)cudaErrorInvalidValue;
  }
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
                 const void* g_out, int n_tiles, int n_tx, int tile_h, int tile_w, int cap, int c, int err, int threads,
                 int blocks_per_tile, int pixels, int smem_bytes, void* g_rows, void* g_buf0, void* stream) {
  return deodr::edge_bwd_launch<float>(table, counts, zbuf, obs, buf_final, g_out, n_tiles, n_tx, tile_h, tile_w,
                                       cap, c, err, threads, blocks_per_tile, pixels, smem_bytes, g_rows, g_buf0,
                                       stream);
}

int edge_bwd_f64(const void* table, const void* counts, const void* zbuf, const void* obs, const void* buf_final,
                 const void* g_out, int n_tiles, int n_tx, int tile_h, int tile_w, int cap, int c, int err, int threads,
                 int blocks_per_tile, int pixels, int smem_bytes, void* g_rows, void* g_buf0, void* stream) {
  return deodr::edge_bwd_launch<double>(table, counts, zbuf, obs, buf_final, g_out, n_tiles, n_tx, tile_h, tile_w,
                                        cap, c, err, threads, blocks_per_tile, pixels, smem_bytes, g_rows, g_buf0,
                                        stream);
}

}  // extern "C"
