// Tiled silhouette edge-overdraw pass (untextured): forward painter's blend
// over the binned edge slots and backward reverse loop with un-blending.
//
// Replaces deodr_tpu/ops/pallas/edge_kernel.py: _fwd_kernel (called by
// _edge_fwd_call) and _bwd_kernel (called by _edge_bwd).
//
// What bounds it on the H100. A band covers few of its tile's pixels: its
// clip planes and y range hold at 0.5 % of the (pixel, slot) pairs of the
// bench scene (edge_kernel.covered_visits), each ~40 float operations in
// image mode with C = 3 (four band planes, y range, depth plane,
// transparency plane, C colour planes and the blend), more in the backward
// (the un-blend divides once per visit and three moments per gradient
// quantity are reduced). Bytes are a handful of planes per pixel (buffer in
// and out, z-buffer, observation in error mode), so the work is bound by
// bytes; the backward adds a reduction across the pixels of a tile for
// every slot, which on a GPU means cross-thread sums or atomics.
//
// The forward. Its first design had one thread per pixel in blocks of 256
// and every pixel tested every band of its tile, staged 32 at a time:
// 0.0320 ms of device time on the bench scene (NVIDIA H100 80GB HBM3,
// 700 W), 14× its bound. This design runs on the forward frame of
// common.cuh (fwd_chunks), as the raster forward does: a warp owns a region
// (16 × 2 patches, P = kEdgeFwdPixels = 2 pixels a lane),
// tests a staged 64-row chunk's bands against the region's rectangle two a
// lane (band_may_cover, the backward's exact cull) and walks the kept ones
// in painter's order, each lane holding its pixels' C colour planes (or one
// residual plane), z-buffer and observations in registers; the band test
// of a kept slot is evaluated without branches (band_mask). Measured
// (chip_smoke.py, same card, float32, device time per call): 0.0075 ms on
// the bench scene (bound 0.0023); built for 1 and 4 pixels a lane
// instead, it took 0.0083 and 0.0097 ms.
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

constexpr int kEdgeFwdPixels = 2;  // P, a lane's pixels in the forward: EDGE_FWD_PIXELS in edge_kernel.py

template <typename T, int C, bool kErr>
__global__ void __launch_bounds__(kThreads)
    edge_fwd_kernel(const T* __restrict__ table, const int* __restrict__ counts, const T* __restrict__ zbuf,
                    const T* __restrict__ obs, const T* __restrict__ buf_in, int n_tx, int tile_h, int tile_w, int cap,
                    int blocks_per_tile, T* __restrict__ buf_out) {
  constexpr int W = 25 + 3 * C;
  constexpr int NCH = kErr ? 1 : C;
  constexpr int P = kEdgeFwdPixels;
  const FwdWarp w(blocks_per_tile, tile_h, tile_w, P);
  const size_t plane = (size_t)(gridDim.x / blocks_per_tile) * tile_h * tile_w;
  const int count = min(counts[w.tile], cap);

  // a lane's P pixels: position, offset, z-buffer, buffer and, in error mode, observation
  unsigned inside = 0;
  T x[P], y[P], zb[P], buf[P][NCH], ob[P][C];
  size_t offset[P];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const Pixel p = region_pixel(w.tile, w.g, w.region, j, n_tx, tile_h, tile_w);
    inside |= (unsigned)p.inside << j;
    offset[j] = p.offset;
    x[j] = (T)p.x;
    y[j] = (T)p.y;
    // read whether or not the tile has slots: the loads do not wait for its count
    zb[j] = p.inside ? zbuf[p.offset] : (T)0;
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch) buf[j][ch] = p.inside ? buf_in[ch * plane + p.offset] : (T)0;
#pragma unroll
    for (int ch = 0; ch < C; ++ch) ob[j][ch] = (kErr && p.inside) ? obs[ch * plane + p.offset] : (T)0;
  }
  T rect[4];
  region_rect(w.tile, w.g, w.region, n_tx, tile_h, tile_w, rect);
  fwd_chunks<T, W>(
      table + (size_t)w.tile * cap * W, count, w.valid,
      [&](const T* r) { return band_may_cover(r, rect[0], rect[1], rect[2], rect[3]); },
      [&](const T* r, int) {
#pragma unroll
        for (int j = 0; j < P; ++j) {
          T t;
          if (!((inside >> j) & 1u) || !band_mask<T, C>(r, x[j], y[j], zb[j], t)) continue;
          T a[C];
#pragma unroll
          for (int ch = 0; ch < C; ++ch) a[ch] = plane3(r + 21 + 3 * ch, x[j], y[j]);
          blend<T, C, kErr>(a, ob[j], t, buf[j]);
        }
      });
#pragma unroll
  for (int j = 0; j < P; ++j) {
    if (!((inside >> j) & 1u)) continue;
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch) buf_out[ch * plane + offset[j]] = buf[j][ch];
  }
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
static cudaError_t edge_fwd_c(bool err, int n_tiles, int threads, int blocks_per_tile, size_t smem_bytes,
                              cudaStream_t s, const T* table, const int* counts, const T* zbuf, const T* obs,
                              const T* buf_in, int n_tx, int tile_h, int tile_w, int cap, T* buf_out) {
  if (!fwd_shape_ok(tile_h, tile_w, threads, blocks_per_tile, kEdgeFwdPixels, smem_bytes, (25 + 3 * C) * sizeof(T)))
    return cudaErrorInvalidValue;
  auto go = [&](auto kernel) {
    kernel<<<n_tiles * blocks_per_tile, threads, smem_bytes, s>>>(table, counts, zbuf, obs, buf_in, n_tx, tile_h,
                                                                  tile_w, cap, blocks_per_tile, buf_out);
    return cudaGetLastError();
  };
  return err ? go(edge_fwd_kernel<T, C, true>) : go(edge_fwd_kernel<T, C, false>);
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
                           int threads, int blocks_per_tile, int smem_bytes, void* buf_out, void* stream) {
  if (n_tiles == 0 || tile_h * tile_w == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  auto args = [&](auto launch) {
    return (int)launch(err != 0, n_tiles, threads, blocks_per_tile, (size_t)smem_bytes, s, (const T*)table,
                       (const int*)counts, (const T*)zbuf, (const T*)obs, (const T*)buf_in, n_tx, tile_h, tile_w,
                       cap, (T*)buf_out);
  };
  switch (c) {
    case 1: return args(edge_fwd_c<T, 1>);
    case 2: return args(edge_fwd_c<T, 2>);
    case 3: return args(edge_fwd_c<T, 3>);
    case 4: return args(edge_fwd_c<T, 4>);
    default: return (int)cudaErrorInvalidValue;
  }
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
                 int n_tiles, int n_tx, int tile_h, int tile_w, int cap, int c, int err, int threads,
                 int blocks_per_tile, int smem_bytes, void* buf_out, void* stream) {
  return deodr::edge_fwd_launch<float>(table, counts, zbuf, obs, buf_in, n_tiles, n_tx, tile_h, tile_w, cap, c, err,
                                       threads, blocks_per_tile, smem_bytes, buf_out, stream);
}

int edge_fwd_f64(const void* table, const void* counts, const void* zbuf, const void* obs, const void* buf_in,
                 int n_tiles, int n_tx, int tile_h, int tile_w, int cap, int c, int err, int threads,
                 int blocks_per_tile, int smem_bytes, void* buf_out, void* stream) {
  return deodr::edge_fwd_launch<double>(table, counts, zbuf, obs, buf_in, n_tiles, n_tx, tile_h, tile_w, cap, c, err,
                                        threads, blocks_per_tile, smem_bytes, buf_out, stream);
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
