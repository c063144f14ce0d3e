// Shared helpers of the tiled rasterizer kernels.
#pragma once

#include <cooperative_groups.h>
#include <cuda_pipeline.h>
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

// ---- shared by the edge-pass kernels (edge_kernel.cu, edge_tex_kernel.cu) ----

constexpr double kTDivEps = 1e-6;

// Affine plane c0·x + (c1·y + c2), in the plain PyTorch versions' operation order.
template <typename T>
__device__ __forceinline__ T plane3(const T* c, T x, T y) {
  return c[0] * x + (c[1] * y + c[2]);
}

// Blend mask and transparency of one edge row at pixel (x, y); row layout
// in edge_kernel.py (the textured row appends its columns after it). T is
// 0.5 where the mask is off, as on the TPU. Every test is evaluated and the
// results are combined with bitwise ands, in the plain versions' operation
// order, so that a slot's shared-memory loads and planes issue together
// instead of as a chain of branches, each waiting on its own load.
template <typename T, int C>
__device__ __forceinline__ bool band_mask(const T* r, T x, T y, T zb, T& t) {
  t = plane3(r + 16, x, y);
  bool cov = (y >= r[19]) & (y <= r[20]);
#pragma unroll
  for (int i = 0; i < 4; ++i) cov &= plane3(r + 3 * i, x, y) > r[12 + i];
  const T z = plane3(r + 21 + 3 * C, x, y);
  const bool mask = cov & (z < zb) & (r[24 + 3 * C] > (T)0.5) & isfinite(t);
  if (!mask) t = (T)0.5;
  return mask;
}

// Whether a band row may cover a pixel of the rectangle [x0, x1] × [y0, y1]:
// false only where no pixel there passes band_mask's y-range and clip-plane
// tests. Exact: each plane is evaluated as band_mask evaluates it, at the
// rectangle's corner that maximises it (a rounded affine plane is monotonic
// in x and in y), so no pixel that passes is culled; NaN culls, as it fails.
template <typename T>
__device__ __forceinline__ bool band_may_cover(const T* r, T x0, T x1, T y0, T y1) {
  bool may = y1 >= r[19] && y0 <= r[20];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const T* c = r + 3 * i;
    may = may && plane3(c, c[0] >= (T)0 ? x1 : x0, c[1] >= (T)0 ? y1 : y0) > r[12 + i];
  }
  return may;
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


// Allow more than 48 KB of dynamic shared memory where a launch needs it.
template <typename K>
cudaError_t reserve_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// ---- the backward frame shared by the edge-pass kernels ----
//
// A tile's pixels are shared by one cluster of blocks. A warp owns a region
// of its tile: its lanes a 16 × 2 patch (rows of 64 bytes for the plane
// loads and stores), each lane p pixels laid out as rp rows × cp columns of
// patches, so a region is 16·cp columns × 2·rp rows. Each warp first tests
// all of a chunk's slots against its region's rectangle (band_may_cover, the
// tests independent of each other), then walks only the slots whose band
// may cover the region, testing those against each pixel.
//
// A thread sums its pixels' moments of each gradient quantity q, (q·x, q·y,
// q), into 16 registers (3 per quantity, at most 5 quantities, the rest 0);
// the warp reduces them with one reduce-scatter butterfly and writes them
// into its own row of the chunk's per-warp partials; the block sums its warps
// in order; the tile's cluster sums its blocks in rank order.

// The warp regions of a tile at p pixels a lane: rp is the largest divisor
// of p that the tile's rows of patches hold. warp_regions in
// ops/kernels/__init__.py counts them the same way.
struct Regions {
  int p, rp, cp, cols, count;
  __host__ __device__ Regions(int tile_h, int tile_w, int pixels) : p(pixels) {
    const int patch_cols = (tile_w + 15) / 16, patch_rows = (tile_h + 1) / 2;
    rp = p;
    while (rp > 1 && (p % rp != 0 || rp > patch_rows)) --rp;
    cp = p / rp;
    cols = (patch_cols + cp - 1) / cp;
    count = cols * ((patch_rows + rp - 1) / rp);
  }
};

// Pixel j of this lane in region `region` of tile `tile` (not inside where
// the region, or the pixel, lies beyond the tile).
__device__ __forceinline__ Pixel region_pixel(int tile, const Regions& g, int region, int j, int n_tx, int tile_h,
                                              int tile_w) {
  const int lane = threadIdx.x & 31;
  const int lx = (region % g.cols) * 16 * g.cp + 16 * (j / g.rp) + (lane & 15);
  const int ly = (region / g.cols) * 2 * g.rp + 2 * (j % g.rp) + (lane >> 4);
  Pixel px;
  px.inside = region < g.count && j < g.p && lx < tile_w && ly < tile_h;
  px.y = (tile / n_tx) * tile_h + (px.inside ? ly : 0);
  px.x = (tile % n_tx) * tile_w + (px.inside ? lx : 0);
  px.offset = (size_t)px.y * (size_t)(n_tx * tile_w) + (size_t)px.x;
  return px;
}

// The rectangle of region `region`, for band_may_cover: x0, x1, y0, y1.
template <typename T>
__device__ __forceinline__ void region_rect(int tile, const Regions& g, int region, int n_tx, int tile_h, int tile_w,
                                            T (&rect)[4]) {
  const int x0 = (tile % n_tx) * tile_w + (region % g.cols) * 16 * g.cp;
  const int y0 = (tile / n_tx) * tile_h + (region / g.cols) * 2 * g.rp;
  rect[0] = (T)x0;
  rect[1] = (T)(x0 + 16 * g.cp - 1);
  rect[2] = (T)y0;
  rect[3] = (T)(y0 + 2 * g.rp - 1);
}

constexpr int kBwdChunk = 64;  // edge rows a backward kernel stages and sums at a time
constexpr int kMoments = 16;  // per-warp partial row width: 3 moments × at most 5 quantities, padded

// Adds the moments of q at pixel (x, y) to m[0..2].
template <typename T>
__device__ __forceinline__ void add_moments(T* m, T q, T x, T y) {
  m[0] += q * x;
  m[1] += q * y;
  m[2] += q;
}

// One step of the reduce-scatter below: lanes whose bit `2·kHalf` is set
// keep values kHalf..2·kHalf−1 (now at 0..kHalf−1), the others values
// 0..kHalf−1, each summed with the partner lane's.
template <int kHalf, typename T>
__device__ __forceinline__ void butterfly_step(T (&v)[kMoments]) {
  const bool upper = (threadIdx.x & (2 * kHalf)) != 0;
#pragma unroll
  for (int i = 0; i < kHalf; ++i) {
    const T send = upper ? v[i] : v[i + kHalf];
    const T keep = upper ? v[i + kHalf] : v[i];
    v[i] = keep + __shfl_xor_sync(kFullMask, send, 2 * kHalf);
  }
}

// Reduce-scatter of 16 values across the warp → the warp's sum of value
// lane >> 1 (lanes 2i and 2i + 1 hold value i), in a fixed order: 16
// shuffles where one warp_sum per value would take 80. Every lane must call
// it; v is overwritten. (Each step a template, so that v stays in registers.)
template <typename T>
__device__ __forceinline__ T warp_reduce_scatter16(T (&v)[kMoments]) {
  butterfly_step<8>(v);
  butterfly_step<4>(v);
  butterfly_step<2>(v);
  butterfly_step<1>(v);
  return v[0] + __shfl_xor_sync(kFullMask, v[0], 1);
}

// Bit k: slot k of the chunk's n staged rows (width w) may cover the warp's
// region (band_may_cover). The tests are independent, so they overlap.
template <typename T>
__device__ __forceinline__ unsigned long long chunk_cover_bits(const T* rows, int w, int n, const T (&rect)[4]) {
  unsigned long long bits = 0;
#pragma unroll 8
  for (int k = 0; k < n; ++k) {
    if (band_may_cover(rows + k * w, rect[0], rect[1], rect[2], rect[3])) bits |= 1ull << k;
  }
  return bits;
}

// The highest slot left in `bits`, removed from them; −1 when none is.
__device__ __forceinline__ int pop_highest(unsigned long long& bits) {
  if (bits == 0) return -1;
  const int k = 63 - __clzll(bits);
  bits &= ~(1ull << k);
  return k;
}

// The lowest slot left in `bits`, removed from them; −1 when none is.
__device__ __forceinline__ int pop_lowest(unsigned long long& bits) {
  if (bits == 0) return -1;
  const int k = __ffsll((long long)bits) - 1;
  bits &= bits - 1;
  return k;
}

// Zeroes the warp's partial rows of a chunk of n slots: a slot the warp does
// not walk, or whose band covers none of its pixels, keeps 0.
template <typename T>
__device__ __forceinline__ void zero_warp_moments(T* warp_acc, int n) {
  for (int i = threadIdx.x & 31; i < n * kMoments; i += 32) warp_acc[i] = (T)0;
  __syncwarp();
}

// Stores the warp's 16 moments of chunk slot k into its partial row, where a
// lane of the warp is in the band.
template <typename T>
__device__ __forceinline__ void store_warp_moments(T* warp_acc, int k, bool any, T (&v)[kMoments]) {
  if (!__any_sync(kFullMask, any)) return;
  const T s = warp_reduce_scatter16(v);
  const int lane = threadIdx.x & 31;
  if ((lane & 1) == 0) warp_acc[k * kMoments + (lane >> 1)] = s;
}

// Block sum of the chunk's per-warp partials (n_warps × kBwdChunk ×
// kMoments, warp-major) into n gradient rows of width gw, warps in order:
// column col of slot k takes moment column_of(k, col), none where negative.
// Call after a block barrier.
template <typename T, typename F>
__device__ __forceinline__ void block_sum_rows(const T* wacc, int n_warps, int n, int gw, T* acc, F column_of) {
  for (int i = threadIdx.x; i < n * gw; i += blockDim.x) {
    const int k = i / gw, m = column_of(k, i % gw);
    T s = (T)0;
    if (m >= 0) {
      for (int w = 0; w < n_warps; ++w) s += wacc[(w * kBwdChunk + k) * kMoments + m];
    }
    acc[i] = s;
  }
}

// Writes out[0 .. n_entries): the sum of the cluster's blocks' `acc`
// (n_entries each, at the same shared offset) in rank order, added to what
// the same thread wrote there in an earlier pass where `accumulate`. Call
// after a cluster barrier.
template <typename T>
__device__ __forceinline__ void cluster_write_rows(const cooperative_groups::cluster_group& cluster, T* acc,
                                                   int n_entries, T* out, bool accumulate) {
  constexpr int kMaxCluster = 8;
  const int n_blocks = (int)cluster.num_blocks();
  const int stride = n_blocks * blockDim.x;
  for (int i = (int)cluster.block_rank() * blockDim.x + threadIdx.x; i < n_entries; i += stride) {
    T part[kMaxCluster];  // all remote reads in flight at once, then summed in rank order
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) part[r] = r < n_blocks ? cluster.map_shared_rank(acc, r)[i] : (T)0;
    T s = accumulate ? out[i] : (T)0;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) {
      if (r < n_blocks) s += part[r];
    }
    out[i] = s;
  }
}

// The chunk-end barrier of an edge backward kernel, split so that a block
// can store what the cluster does not read between its arrive (which
// publishes the block's sums: a release) and its wait (an acquire). A
// cluster of one block needs a block barrier only.
__device__ __forceinline__ void cluster_arrive(const cooperative_groups::cluster_group& cluster) {
  if (cluster.num_blocks() > 1) asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait(const cooperative_groups::cluster_group& cluster) {
  if (cluster.num_blocks() > 1)
    asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
  else
    __syncthreads();
}

// The end of an edge backward kernel: no block of a cluster leaves while
// another may still read its shared memory. A relaxed arrive (each thread's
// remote reads are consumed by then) spares the full memory fence and L1
// invalidation of cluster.sync(); a tile without slots was read by no one.
__device__ __forceinline__ void cluster_exit(const cooperative_groups::cluster_group& cluster, int count) {
  if (cluster.num_blocks() == 1 || count == 0) return;
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n\tbarrier.cluster.wait.aligned;" ::: "memory");
}

// Shared memory of an edge backward kernel: the chunk's rows (width w), the
// per-warp partials, and two chunks' block sums (gradient row width gw; two,
// so that one cluster barrier per chunk suffices). edge_bwd_launch_shape in
// ops/kernels/edge_kernel.py computes the size the launch gets; the
// launchers refuse any other.
__host__ __device__ constexpr size_t edge_bwd_smem_elems(int w, int gw, int n_warps) {
  return (size_t)kBwdChunk * w + (size_t)n_warps * kBwdChunk * kMoments + 2 * (size_t)kBwdChunk * gw;
}

// A lane's P pixels in an edge backward kernel (region_pixel j): position,
// depth, the final buffer being un-blended, the carried cotangent and, in
// error mode, the observation.
template <typename T, int C, bool kErr, int P>
struct BwdPixels {
  static constexpr int NCH = kErr ? 1 : C;
  unsigned inside;  // bit j: pixel j lies in the tile
  T x[P], y[P], zb[P], buf[P][NCH], gb[P][NCH], ob[P][C];
  __device__ __forceinline__ bool in(int j) const { return (inside >> j) & 1u; }
};

// The body of both edge backward kernels, over a table of row width W with
// gradient rows of width GW, launched by launch_tile_clusters. A lane holds
// `pixels` ≤ P pixels of a region; a tile with more regions than its cluster
// has warps takes several passes over its slots. Per pass and 64-row chunk
// (highest first): stage the rows, test them against the warp's region
// (chunk_cover_bits), then
//   walk(rows, cover, px, warp_acc)
// walks the slots of `cover` from the highest, un-blends px and stores each
// slot's moments (store_warp_moments); the block sums its warps, the cluster
// its blocks, and column_of(row, col) names the moment column of gradient
// column col for a slot's row (none where negative: written 0). Rows ≥
// count are written 0, and g_buf0 once a pixel's last chunk is walked.
template <typename T, int C, bool kErr, int P, int W, int GW, typename Walk, typename ColumnOf>
__device__ __forceinline__ void edge_bwd_frame(const T* __restrict__ table, const int* __restrict__ counts,
                                               const T* __restrict__ zbuf, const T* __restrict__ obs,
                                               const T* __restrict__ buf_final, const T* __restrict__ g_out, int n_tx,
                                               int tile_h, int tile_w, int cap, int pixels, T* __restrict__ g_rows,
                                               T* __restrict__ g_buf0, const Walk& walk, const ColumnOf& column_of) {
  namespace cg = cooperative_groups;
  constexpr int NCH = kErr ? 1 : C;
  const cg::cluster_group cluster = cg::this_cluster();
  const int n_blocks = (int)cluster.num_blocks();
  const int tile = blockIdx.x / n_blocks;
  const int n_warps = blockDim.x / 32, warp = threadIdx.x / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* rows = reinterpret_cast<T*>(smem_raw);         // kBwdChunk × W
  T* wacc = rows + kBwdChunk * W;                   // n_warps × kBwdChunk × kMoments
  T* bacc = wacc + n_warps * kBwdChunk * kMoments;  // 2 × kBwdChunk × GW
  T* warp_acc = wacc + warp * kBwdChunk * kMoments;

  const size_t plane = (size_t)(gridDim.x / n_blocks) * tile_h * tile_w;
  const int cluster_threads = n_blocks * blockDim.x;
  const int first = (int)cluster.block_rank() * blockDim.x + threadIdx.x;
  const int cluster_warps = cluster_threads / 32;
  const Regions regions(tile_h, tile_w, pixels);
  const int count = min(counts[tile], cap);
  const T* tile_rows = table + (size_t)tile * cap * W;
  T* tile_grads = g_rows + (size_t)tile * cap * GW;
  auto column_at = [rows, &column_of](int k, int col) { return column_of(rows + k * W, col); };
  int chunk = 0;  // chunks walked so far over all passes: picks the block-sum buffer

  for (int pass_base = 0; pass_base < regions.count; pass_base += cluster_warps) {
    const int region = pass_base + first / 32;  // this warp's region in this pass
    const bool valid = region < regions.count;
    const bool last_pass = pass_base + cluster_warps >= regions.count;
    T rect[4];
    region_rect(tile, regions, region, n_tx, tile_h, tile_w, rect);
    BwdPixels<T, C, kErr, P> px;
    px.inside = 0;
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const Pixel p = region_pixel(tile, regions, region, j, n_tx, tile_h, tile_w);
      px.inside |= (unsigned)p.inside << j;
      px.x[j] = (T)p.x;
      px.y[j] = (T)p.y;
      const bool walked = p.inside && count > 0;  // a tile without slots reads the cotangent only
      px.zb[j] = walked ? zbuf[p.offset] : (T)0;
#pragma unroll
      for (int ch = 0; ch < NCH; ++ch) {
        px.buf[j][ch] = walked ? buf_final[ch * plane + p.offset] : (T)0;
        px.gb[j][ch] = p.inside ? g_out[ch * plane + p.offset] : (T)0;
      }
#pragma unroll
      for (int ch = 0; ch < C; ++ch) px.ob[j][ch] = (kErr && walked) ? obs[ch * plane + p.offset] : (T)0;
    }
    // this pass's buffer cotangents and, in the last pass, the rows at or
    // above count (0: g_rows comes from torch.empty), stored once final
    auto store_final = [&]() {
#pragma unroll
      for (int j = 0; j < P; ++j) {
        if (!px.in(j)) continue;
        const size_t o = region_pixel(tile, regions, region, j, n_tx, tile_h, tile_w).offset;
#pragma unroll
        for (int ch = 0; ch < NCH; ++ch) g_buf0[ch * plane + o] = px.gb[j][ch];
      }
      if (last_pass) {
        for (int i = first; i < (cap - count) * GW; i += cluster_threads) tile_grads[(size_t)count * GW + i] = (T)0;
      }
    };
    if (count == 0) store_final();

    for (int hi = count; hi > 0; hi -= kBwdChunk, ++chunk) {
      const int lo = max(0, hi - kBwdChunk);
      const int n = hi - lo;
      __syncthreads();  // the previous chunk's rows and partials are no longer read
      for (int i = threadIdx.x; i < n * W; i += blockDim.x) rows[i] = tile_rows[(size_t)lo * W + i];
      __syncthreads();
      zero_warp_moments(warp_acc, n);
      walk(rows, valid ? chunk_cover_bits(rows, W, n, rect) : 0ull, px, warp_acc);  // cover: warp-uniform
      __syncthreads();
      T* acc = bacc + (chunk & 1) * kBwdChunk * GW;
      block_sum_rows(wacc, n_warps, n, GW, acc, column_at);
      cluster_arrive(cluster);  // this block's sums are in place
      if (lo == 0) store_final();
      cluster_wait(cluster);  // every block's sums are in place; the other buffer's readers are done
      cluster_write_rows(cluster, acc, n * GW, tile_grads + (size_t)lo * GW, pass_base > 0);
    }
  }
  if (regions.count == 0) {  // a tile without pixels: its rows are 0
    for (int i = first; i < cap * GW; i += cluster_threads) tile_grads[i] = (T)0;
  }
  cluster_exit(cluster, count);
}

// Launches a backward kernel with one cluster of blocks_per_tile blocks of
// `threads` threads per tile and `smem` bytes of dynamic shared memory.
template <typename K, typename... Args>
cudaError_t launch_tile_clusters(K kernel, int n_tiles, int threads, int blocks_per_tile, size_t smem,
                                 cudaStream_t stream, Args... args) {
  if (threads % 32 || threads < 32 || threads > kThreads || blocks_per_tile < 1 || blocks_per_tile > 8)
    return cudaErrorInvalidValue;
  cudaError_t err = reserve_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = blocks_per_tile;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_tiles * blocks_per_tile);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// ---- the forward frame shared by the raster, edge and textured edge forward kernels ----
//
// A warp owns a region of its tile, laid out as in the backward frame (its
// lanes a 16 × 2 patch, each lane P pixels in as many patches); a tile's
// regions are spread over blocks_per_tile independent blocks of a 1-D grid.
// The block stages its tile's rows in shared memory 64 at a time, with
// asynchronous copies (every copy of a chunk in flight at once; the next
// chunk's copies are issued before the current one is walked). Per chunk,
// each lane tests slots lane and lane + 32 against its warp's region
// rectangle, two ballots give the chunk's 64-bit mask, and the warp walks its
// set bits in ascending slot order (the painter's order of the edge pass and
// the tie order of the solid pass), every lane reading the same row (a
// shared-memory broadcast) and testing its own pixels against it. There is
// no reduction: each lane keeps its pixels' state in registers and stores it
// at the end.

constexpr int kFwdChunk = 64;  // table rows a forward kernel walks at a time (two chunks are staged)

// Launch shape of a forward kernel at `pixels` pixels a lane: 256 threads a
// block (fewer on a tile of fewer regions) and as many blocks a tile as its
// regions need. fwd_launch_shape in ops/kernels/__init__.py computes the
// same; the launchers refuse any other.
struct FwdShape {
  int threads, blocks_per_tile;
};

__host__ __device__ inline FwdShape fwd_shape(int tile_h, int tile_w, int pixels) {
  const Regions g(tile_h, tile_w, pixels);
  const int warps = g.count > 1 ? g.count : 1;
  const int threads = 32 * warps < kThreads ? 32 * warps : kThreads;
  return {threads, (32 * warps + threads - 1) / threads};
}

// Whether a launch of a forward kernel over rows of `row_bytes` is the one
// fwd_shape gives at the kernel's `pixels` a lane, with two chunks of rows
// as its dynamic shared memory.
inline bool fwd_shape_ok(int tile_h, int tile_w, int threads, int blocks_per_tile, int pixels, size_t smem_bytes,
                         size_t row_bytes) {
  const FwdShape s = fwd_shape(tile_h, tile_w, pixels);
  return threads == s.threads && blocks_per_tile == s.blocks_per_tile && smem_bytes == 2 * kFwdChunk * row_bytes;
}

// This warp's tile and region in a forward launch, and whether the region
// lies in the tile (a tile's last block may have warps beyond its regions).
struct FwdWarp {
  int tile, region;
  bool valid;
  Regions g;
  __device__ FwdWarp(int blocks_per_tile, int tile_h, int tile_w, int pixels)
      : tile(blockIdx.x / blocks_per_tile),
        region((blockIdx.x % blocks_per_tile) * (blockDim.x / 32) + threadIdx.x / 32),
        g(tile_h, tile_w, pixels) {
    valid = region < g.count;
  }
};

// Starts the asynchronous copy of rows [base, min(base + 64, count)) (width
// W) into dst, as one commit group of this thread.
template <typename T, int W>
__device__ __forceinline__ void fwd_stage(T* dst, const T* __restrict__ tile_rows, int base, int count) {
  const int n = min(kFwdChunk, count - base) * W;
  const T* src = tile_rows + (size_t)base * W;
  for (int i = threadIdx.x; i < n; i += blockDim.x) __pipeline_memcpy_async(dst + i, src + i, sizeof(T));
  __pipeline_commit();
}

// The chunks of a tile's `count` rows (width W, from tile_rows): stages each
// in shared memory, then, in warps whose region is valid, calls
// visit(row, slot) for every slot whose row may_cover(row) keeps, in
// ascending order. Every thread of the block must call it.
template <typename T, int W, typename MayCover, typename Visit>
__device__ __forceinline__ void fwd_chunks(const T* __restrict__ tile_rows, int count, bool valid,
                                           const MayCover& may_cover, const Visit& visit) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* rows = reinterpret_cast<T*>(smem_raw);  // 2 × kFwdChunk × W: chunk c in buffer c & 1
  const int lane = threadIdx.x & 31;
  if (count > 0) fwd_stage<T, W>(rows, tile_rows, 0, count);
  for (int base = 0, c = 0; base < count; base += kFwdChunk, ++c) {
    const T* chunk = rows + (c & 1) * kFwdChunk * W;
    if (base + kFwdChunk < count) {  // the next chunk's copies fly while this one is walked
      fwd_stage<T, W>(rows + ((c + 1) & 1) * kFwdChunk * W, tile_rows, base + kFwdChunk, count);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();  // the chunk is in place
    if (valid) {      // warp-uniform
      const int n = min(kFwdChunk, count - base);
      const bool lo = lane < n && may_cover(chunk + lane * W);
      const bool hi = lane + 32 < n && may_cover(chunk + (lane + 32) * W);
      unsigned long long bits = (unsigned long long)__ballot_sync(kFullMask, lo) |
                                ((unsigned long long)__ballot_sync(kFullMask, hi) << 32);
      for (int k = pop_lowest(bits); k >= 0; k = pop_lowest(bits)) visit(chunk + k * W, base + k);
    }
    __syncthreads();  // no warp reads the chunk's buffer when the chunk after next is staged into it
  }
}

}  // namespace deodr
