// Tiled solid pass of the rasterizer: forward (z-argmin winner and the
// winner's affine attribute planes) and backward (per-slot reduction of the
// pixel cotangents against (x, y, 1)).
//
// Replaces deodr_tpu/ops/pallas/raster_kernel.py: _fwd_kernel (called by
// _raster_fwd_call) and _bwd_kernel (called by _raster_bwd).
//
// What bounds it on the H100. Forward: a slot's triangle covers few of its
// tile's pixels (1.7 % of the (pixel, slot) pairs on the duck, 7.9 % on the
// bench scene: raster_kernel.covered_visits), ~33 float operations per
// covered pair, and every pixel is written once (8 + 4·D bytes), so the
// work it must do is bound by bytes (11 MB on the duck, 3.5 µs at 3.35
// TB/s). What holds it back is latency: a launch, a chain of dependent
// loads (slot count, table rows, the winner's attribute row) and, in the
// tiles that hold many small triangles, a warp's walk over its slots.
// Backward: reads one slot id and D cotangents per pixel and does 3·D
// products, bound by bytes (about 10 MB on the duck, 3 µs at 3.35 TB/s);
// what holds it back is the reduction: many pixels adding into few table
// entries.
//
// The forward. Its first design had one thread per pixel in blocks of 256
// (grid = tiles × pixel chunks), and every pixel tested every slot of its
// tile: 0.0375 ms of device time on the duck, 0.0139 on the bench scene
// (NVIDIA H100 80GB HBM3, 700 W). This design runs on the forward frame of
// common.cuh (fwd_chunks): a warp owns a region of its tile (16 × 2
// patches, P = kRasterFwdPixels = 1 pixel a lane), tests a
// staged 64-row chunk's slots against the region's rectangle two a lane
// (raster_may_cover, exact), and walks only the kept slots (7 % of the
// (region, slot) pairs on the duck) in ascending order, keeping (best z,
// best slot) per pixel; a strict < keeps the lowest slot on ties. The
// tests are evaluated without branches (raster_covers): written with
// short-circuit ands they compiled to a chain of branches, each waiting on
// its own shared-memory load, and the walk of the warps of the duck's
// fullest tiles set the kernel's time (0.0180 ms, against 0.0109 without
// the branches; chip_smoke.py, same card). The winner's
// attribute planes are evaluated once at the end, four at a time with
// every load of a batch in flight. The file is compiled with -fmad=false,
// so each plane rounds like the plain PyTorch version, and without fast
// math, so the right-edge test "plane > -FLT_MIN" sees denormals. Slot
// pairing, the TPU's latency device, is not needed here. Measured
// (chip_smoke.py, same card, float32, device time per call): 0.0109 ms on
// the duck (bound 0.0035), 0.0077 on the bench scene (bound 0.0016); built
// for 2 and 4 pixels a lane instead, it took 0.0120 and 0.0169 ms on the
// duck, 0.0070 and 0.0063 on the bench scene.
//
// The backward. Its first design had the forward's grid: each 256-pixel
// block zeroed and flushed a count × 3D shared accumulator for its whole
// tile with global atomics (8 contending blocks per entry on the duck's
// 16×128 tiles, 24 on the bench's 48×128), into a table zeroed by a
// separate memset, and in a warp spanning several slots every lane issued
// 3D shared atomics onto the warp's few rows, which serialize: 0.0589 ms
// of device time on the duck, 0.0377 on the bench. This design gives each
// tile one owner: the tile's blocks form one thread-block cluster of at
// most 8 blocks (the portable size) of 256 threads (fewer on a tile of
// fewer pixels); a block loops over pixels when the cluster has fewer
// threads than the tile has pixels. The launch shape comes from
// raster_bwd_launch_shape in raster_kernel.py. Each block reduces its
// pixels into its own count × 3D shared accumulator: a warp on one slot
// with a shuffle sum and one atomic per entry, a mixed warp with a
// segmented sum over each run of equal slots among neighbouring lanes, so
// that only a run's last lane adds into shared memory. After a cluster
// barrier the blocks write the tile's cap × 3D rows together, each entry
// summing the blocks' partials in rank order through distributed shared
// memory (plain reads, no remote atomics, a fixed order across blocks),
// rows at or above count as 0: coalesced stores, no global atomics and no
// memset.
//
// Measured (chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W, float32,
// device time per call, two runs): 0.0146-0.0150 ms on the duck (D = 7,
// bound 0.0030) and 0.0120-0.0122 ms on the bench (D = 3, bound 0.0013).
// Two other launch shapes were measured in the same runs and dropped:
// clusters of 1024-thread blocks took 0.0151-0.0153 ms on the duck and
// 0.0146 on the bench, one 1024-thread block per tile 0.0159-0.0160 and
// 0.0233-0.0235 ms (44 blocks on 132 SMs at the bench).

#include <cooperative_groups.h>

#include "common.cuh"

namespace deodr {

constexpr int kSetupW = 22;  // setup row width (see raster_kernel.py)

// Coverage and depth of setup row r at pixel (x, y), in the plain PyTorch
// version's operation order: inside one of the two sub-triangles (y range,
// left plane > 0, right plane > −tiny), inside the x range, a valid row and
// a finite depth. Every test is evaluated and the results are combined with
// bitwise ands: short-circuit evaluation compiles to a chain of branches,
// each waiting on its own shared-memory load, which set the walk's pace.
// Persp: the depth is 1 / plane (the plane of 1/z); a pixel where it is not
// finite is not covered. Strict rows only: the non-strict coverage takes
// the x ranges of nonstrict_bounds.
template <typename T, bool Persp>
__device__ __forceinline__ T raster_depth(const T* r, T x, T y) {
  const T zlin = plane3(r + 18, x, y);
  return Persp ? (T)1 / zlin : zlin;
}

template <typename T, bool Persp>
__device__ __forceinline__ bool raster_covers(const T* r, T x, T y, T& z) {
  const T neg_tiny = -Limits<T>::tiny();
  bool cov = false;
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    cov |= (y >= r[p]) & (y <= r[2 + p]) & (plane3(r + 4 + 3 * p, x, y) > (T)0) &
           (plane3(r + 10 + 3 * p, x, y) > neg_tiny);
  }
  z = raster_depth<T, Persp>(r, x, y);
  return cov & (x >= r[16]) & (x <= r[17]) & (r[21] > (T)0.5) & isfinite(z);
}

// max and min that return NaN where either operand is NaN, as torch.maximum
// and torch.minimum do (fmax and fmin drop it).
template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) {
  return (a > b) | (a != a) ? a : b;
}
template <typename T>
__device__ __forceinline__ T nan_min(T a, T b) {
  return (a < b) | (a != a) ? a : b;
}

// The rational x range of a non-strict row (setup rows as triangle_row_setup
// makes them, not sign-normalised), as _coverage_and_z's non-strict mode
// computes it: sub-triangle p of row r covers x_begin_p ≤ x ≤ x_end_p on
// pixel row y, with x_begin_p = max(x_lo, ceil_div(−(b·y + c), a, x_lo − 1,
// x_hi)) of its left edge and x_end_p = min(x_hi, floor_div(...)) of its
// right edge, and the den == 0 rules of floor_div / ceil_div. The four
// bounds are uniform along a pixel row, so they are computed once per row:
// lane L of each half-warp (one pixel row of the region, P = 1) computes
// bound L & 3 of its row (sub-triangle (L >> 1) & 1, the left edge's
// ceiling where L is even, the right edge's floor where odd), and every lane
// reads the four of its row with shuffles. Every lane of the warp must call
// it. b[0..3] = x_begin_0, x_end_0, x_begin_1, x_end_1.
template <typename T>
__device__ __forceinline__ void nonstrict_bounds(const T* r, T yrow, int lane, T (&b)[4]) {
  const int p = (lane >> 1) & 1;
  const bool right = lane & 1;
  const T* eq = r + (right ? 10 : 4) + 3 * p;
  const T num = -(eq[1] * yrow + eq[2]);
  const T den = eq[0];
  const T lo = r[16] - (T)1, hi = r[17];
  const T quo = num / (den == (T)0 ? (T)1 : den);
  T q = nan_min(nan_max(right ? floor(quo) : ceil(quo), lo), hi);
  if (den == (T)0) q = (right ? num <= (T)0 : num < (T)0) ? hi : lo;
  q = right ? nan_min(hi, q) : nan_max(r[16], q);
  const int base = lane & 16;
#pragma unroll
  for (int k = 0; k < 4; ++k) b[k] = __shfl_sync(kFullMask, q, base + k);
}

template <typename T, bool Persp>
__device__ __forceinline__ bool raster_covers_nonstrict(const T* r, const T (&b)[4], T x, T y, T& z) {
  bool cov = false;
#pragma unroll
  for (int p = 0; p < 2; ++p) cov |= (y >= r[p]) & (y <= r[2 + p]) & (x >= b[2 * p]) & (x <= b[2 * p + 1]);
  z = raster_depth<T, Persp>(r, x, y);
  return cov & (r[21] > (T)0.5) & isfinite(z);
}

// Whether setup row r may cover a pixel of the rectangle [x0, x1] × [y0, y1]:
// false only where no pixel there passes raster_covers's validity, x-range,
// y-range and edge-plane tests. Exact, as band_may_cover is: the rectangle
// is clipped to the row's x range and to each sub-triangle's y range (a
// pixel that passes lies inside both), and each edge plane is evaluated as
// raster_covers evaluates it, at the clipped rectangle's corner that
// maximises it; NaN culls, as it fails. Evaluated without branches, as
// raster_covers is. Non-strict rows are not sign-normalised, so their cull
// keeps the validity, x-range and y-range tests only (a superset of what
// their rational ranges cover).
template <typename T, bool Strict>
__device__ __forceinline__ bool raster_may_cover(const T* r, T x0, T x1, T y0, T y1) {
  const T cx0 = fmax(x0, r[16]), cx1 = fmin(x1, r[17]);
  const T neg_tiny = -Limits<T>::tiny();
  bool may = false;
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const T cy0 = fmax(y0, r[p]), cy1 = fmin(y1, r[2 + p]);
    const T* le = r + 4 + 3 * p;
    const T* re = r + 10 + 3 * p;
    bool ok = (y1 >= r[p]) & (y0 <= r[2 + p]);
    if (Strict) {
      ok &= (plane3(le, le[0] >= (T)0 ? cx1 : cx0, le[1] >= (T)0 ? cy1 : cy0) > (T)0) &
            (plane3(re, re[0] >= (T)0 ? cx1 : cx0, re[1] >= (T)0 ? cy1 : cy0) > neg_tiny);
    }
    may |= ok;
  }
  return may & (r[21] > (T)0.5) & (x1 >= r[16]) & (x0 <= r[17]);
}

// The forward, on the frame of common.cuh (fwd_chunks): a lane keeps (best
// z, best slot) of each of its P pixels over the slots its warp's region
// may be covered by, in ascending order; a strict < keeps the lowest slot
// on ties. The winner's D attribute planes are evaluated once at the end.
// Strict (sign-normalised rows) and Persp (z = 1 / plane) are the modes of
// the TPU kernel's _coverage_and_z; the strict, affine instantiation is the
// kernel of the main path.
constexpr int kRasterFwdPixels = 1;  // P, a lane's pixels: RASTER_FWD_PIXELS in raster_kernel.py

template <typename T, bool Strict, bool Persp>
__global__ void __launch_bounds__(kThreads)
    raster_fwd_kernel(const T* __restrict__ setup, const T* __restrict__ affine, const int* __restrict__ counts,
                      int n_tx, int tile_h, int tile_w, int cap, int d, int blocks_per_tile, int* __restrict__ slot_map,
                      T* __restrict__ z_out, T* __restrict__ vals) {
  constexpr int P = kRasterFwdPixels;
  const FwdWarp w(blocks_per_tile, tile_h, tile_w, P);
  const int count = min(counts[w.tile], cap);
  T x[P], y[P], best_z[P];
  int best[P];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const Pixel p = region_pixel(w.tile, w.g, w.region, j, n_tx, tile_h, tile_w);
    x[j] = (T)p.x;
    y[j] = (T)p.y;
    best_z[j] = (T)INFINITY;
    best[j] = cap;
  }
  T rect[4];
  region_rect(w.tile, w.g, w.region, n_tx, tile_h, tile_w, rect);
  fwd_chunks<T, kSetupW>(
      setup + (size_t)w.tile * cap * kSetupW, count, w.valid,
      [&](const T* r) { return raster_may_cover<T, Strict>(r, rect[0], rect[1], rect[2], rect[3]); },
      [&](const T* r, int slot) {
        if constexpr (Strict) {
#pragma unroll
          for (int j = 0; j < P; ++j) {
            T z;
            if (raster_covers<T, Persp>(r, x[j], y[j], z) && z < best_z[j]) {
              best_z[j] = z;
              best[j] = slot;
            }
          }
        } else {
          static_assert(P == 1, "nonstrict_bounds shares a pixel row's bounds across a half-warp");
          T b[4];
          nonstrict_bounds(r, rect[2] + (T)((threadIdx.x & 31) >> 4), threadIdx.x & 31, b);
          T z;
          if (raster_covers_nonstrict<T, Persp>(r, b, x[0], y[0], z) && z < best_z[0]) {
            best_z[0] = z;
            best[0] = slot;
          }
        }
      });
  const size_t plane = (size_t)(gridDim.x / blocks_per_tile) * tile_h * tile_w;
  size_t offset[P];
  unsigned inside = 0;
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const Pixel p = region_pixel(w.tile, w.g, w.region, j, n_tx, tile_h, tile_w);
    inside |= (unsigned)p.inside << j;
    offset[j] = p.offset;
    if (!p.inside) continue;
    slot_map[p.offset] = best[j];
    z_out[p.offset] = best_z[j];
  }
  // the winners' attribute planes, kAttrBatch at a time: every load of a batch in flight before its stores
  constexpr int kAttrBatch = 4;
  for (int k0 = 0; k0 < d; k0 += kAttrBatch) {
    T a[P][kAttrBatch][3];
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const bool hit = ((inside >> j) & 1u) && best[j] < cap;
      const T* row = affine + ((size_t)w.tile * cap + (hit ? best[j] : 0)) * 3 * d;
#pragma unroll
      for (int q = 0; q < kAttrBatch; ++q) {
        const int k = k0 + q;
#pragma unroll
        for (int m = 0; m < 3; ++m) a[j][q][m] = (hit && k < d) ? row[m * d + k] : (T)0;
      }
    }
#pragma unroll
    for (int j = 0; j < P; ++j) {
      if (!((inside >> j) & 1u)) continue;
#pragma unroll
      for (int q = 0; q < kAttrBatch; ++q) {
        if (k0 + q < d) vals[(k0 + q) * plane + offset[j]] = a[j][q][0] * x[j] + (a[j][q][1] * y[j] + a[j][q][2]);
      }
    }
  }
}

// Adds the three moments of (v·x, v·y, v) over a run of equal slots ending
// at this lane into acc[0], acc[d], acc[2d], from the run's last lane.
// Lanes lane-k for k < lane-head belong to the run; `steps` (warp-uniform)
// covers the longest run of the warp. Every lane of the warp must call it.
template <typename T>
__device__ __forceinline__ void add_run(T* acc, int d, T g, T x, T y, int lane, int head, int steps, bool last) {
  T vx = g * x, vy = g * y, vc = g;
  for (int k = 0, off = 1; k < steps; ++k, off <<= 1) {
    const T ux = __shfl_up_sync(kFullMask, vx, off);
    const T uy = __shfl_up_sync(kFullMask, vy, off);
    const T uc = __shfl_up_sync(kFullMask, vc, off);
    if (lane - off >= head) {
      vx += ux;
      vy += uy;
      vc += uc;
    }
  }
  if (last) {
    atomicAdd(&acc[0], vx);
    atomicAdd(&acc[d], vy);
    atomicAdd(&acc[2 * d], vc);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    raster_bwd_kernel(const int* __restrict__ slot_map, const T* __restrict__ g_vals, const int* __restrict__ counts,
                      int n_tx, int tile_h, int tile_w, int cap, int d, T* __restrict__ g_table) {
  namespace cg = cooperative_groups;
  const cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* acc = reinterpret_cast<T*>(smem_raw);  // count × 3d partial sums of this block
  const int n_blocks = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int tile = blockIdx.x / n_blocks;
  const int count = min(counts[tile], cap);
  const int width = 3 * d;
  const int n_acc = count * width;
  for (int i = threadIdx.x; i < n_acc; i += blockDim.x) acc[i] = (T)0;
  __syncthreads();

  const int n_px = tile_h * tile_w;
  const size_t plane = (size_t)(gridDim.x / n_blocks) * n_px;
  const int lane = threadIdx.x & 31;
  const int stride = n_blocks * blockDim.x;
  for (int base = rank * blockDim.x; base < n_px; base += stride) {  // block-uniform trip count
    const Pixel px = pixel_at(tile, base + threadIdx.x, n_tx, tile_h, tile_w);
    const T x = (T)px.x, y = (T)px.y;
    const int s = px.inside ? slot_map[px.offset] : cap;
    const bool hit = s < count;
    // runs of equal slots among neighbouring lanes: a head where the slot changes
    const int s_prev = __shfl_up_sync(kFullMask, s, 1);
    const unsigned heads = __ballot_sync(kFullMask, lane == 0 || s != s_prev);
    if (heads == 1u) {  // one slot over the whole warp
      if (!hit) continue;  // warp-uniform
      for (int j = 0; j < d; ++j) {
        const T g = g_vals[j * plane + px.offset];
        const T sx = warp_sum(g * x), sy = warp_sum(g * y), sc = warp_sum(g);
        if (lane == 0) {
          atomicAdd(&acc[s * width + j], sx);
          atomicAdd(&acc[s * width + d + j], sy);
          atomicAdd(&acc[s * width + 2 * d + j], sc);
        }
      }
      continue;
    }
    // segmented sums: each run's last lane adds the run's total, once per table entry
    const int head = 31 - __clz(heads & (kFullMask >> (31 - lane)));
    const bool last = hit && (lane == 31 || ((heads >> (lane + 1)) & 1u));
    const int longest = __reduce_max_sync(kFullMask, hit ? (unsigned)(lane - head + 1) : 1u);
    const int steps = 32 - __clz(longest - 1);  // ⌈log2(longest)⌉
    T* row = acc + (hit ? s : 0) * width;
    for (int j = 0; j < d; ++j) {
      const T g = hit ? g_vals[j * plane + px.offset] : (T)0;
      add_run(row + j, d, g, x, y, lane, head, steps, last);
    }
  }

  // the tile's cap × 3d rows, written once: entry e sums the blocks' partials in rank order
  cluster.sync();
  T* out = g_table + (size_t)tile * cap * width;
  for (int e = rank * blockDim.x + threadIdx.x; e < cap * width; e += stride) {
    T v = (T)0;
    if (e < n_acc) {
      for (int r = 0; r < n_blocks; ++r) v += cluster.map_shared_rank(acc, r)[e];
    }
    out[e] = v;
  }
  cluster.sync();  // no block leaves while another still reads its shared memory
}

template <typename T, bool Strict, bool Persp>
static void raster_fwd_start(const void* setup, const void* affine, const void* counts, int n_tiles, int n_tx,
                             int tile_h, int tile_w, int cap, int d, int threads, int blocks_per_tile, int smem_bytes,
                             void* slot_map, void* z, void* vals, void* stream) {
  raster_fwd_kernel<T, Strict, Persp><<<n_tiles * blocks_per_tile, threads, smem_bytes, (cudaStream_t)stream>>>(
      (const T*)setup, (const T*)affine, (const int*)counts, n_tx, tile_h, tile_w, cap, d, blocks_per_tile,
      (int*)slot_map, (T*)z, (T*)vals);
}

template <typename T>
static int raster_fwd_launch(const void* setup, const void* affine, const void* counts, int n_tiles, int n_tx,
                             int tile_h, int tile_w, int cap, int d, int strict, int persp, int threads,
                             int blocks_per_tile, int smem_bytes, void* slot_map, void* z, void* vals, void* stream) {
  if (n_tiles == 0 || tile_h * tile_w == 0) return 0;
  if (!fwd_shape_ok(tile_h, tile_w, threads, blocks_per_tile, kRasterFwdPixels, (size_t)smem_bytes,
                    kSetupW * sizeof(T)))
    return (int)cudaErrorInvalidValue;
  auto start = strict ? (persp ? raster_fwd_start<T, true, true> : raster_fwd_start<T, true, false>)
                      : (persp ? raster_fwd_start<T, false, true> : raster_fwd_start<T, false, false>);
  start(setup, affine, counts, n_tiles, n_tx, tile_h, tile_w, cap, d, threads, blocks_per_tile, smem_bytes, slot_map,
        z, vals, stream);
  return (int)cudaGetLastError();
}

template <typename T>
static int raster_bwd_launch(const void* slot_map, const void* g_vals, const void* counts, int n_tiles, int n_tx,
                             int tile_h, int tile_w, int cap, int d, int threads, int blocks_per_tile,
                             void* g_table, void* stream) {
  if (n_tiles == 0 || cap == 0) return 0;  // an empty table; a tile without pixels still gets its zero rows
  const size_t smem = (size_t)cap * 3 * d * sizeof(T);
  return (int)launch_tile_clusters(raster_bwd_kernel<T>, n_tiles, threads, blocks_per_tile, smem,
                                   (cudaStream_t)stream, (const int*)slot_map, (const T*)g_vals, (const int*)counts,
                                   n_tx, tile_h, tile_w, cap, d, (T*)g_table);
}

}  // namespace deodr

extern "C" {

const char* deodr_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

int raster_fwd_f32(const void* setup, const void* affine, const void* counts, int n_tiles, int n_tx, int tile_h,
                   int tile_w, int cap, int d, int strict, int persp, int threads, int blocks_per_tile, int smem_bytes,
                   void* slot_map, void* z, void* vals, void* stream) {
  return deodr::raster_fwd_launch<float>(setup, affine, counts, n_tiles, n_tx, tile_h, tile_w, cap, d, strict, persp,
                                         threads, blocks_per_tile, smem_bytes, slot_map, z, vals, stream);
}

int raster_fwd_f64(const void* setup, const void* affine, const void* counts, int n_tiles, int n_tx, int tile_h,
                   int tile_w, int cap, int d, int strict, int persp, int threads, int blocks_per_tile, int smem_bytes,
                   void* slot_map, void* z, void* vals, void* stream) {
  return deodr::raster_fwd_launch<double>(setup, affine, counts, n_tiles, n_tx, tile_h, tile_w, cap, d, strict,
                                          persp, threads, blocks_per_tile, smem_bytes, slot_map, z, vals, stream);
}

int raster_bwd_f32(const void* slot_map, const void* g_vals, const void* counts, int n_tiles, int n_tx, int tile_h,
                   int tile_w, int cap, int d, int threads, int blocks_per_tile, void* g_table, void* stream) {
  return deodr::raster_bwd_launch<float>(slot_map, g_vals, counts, n_tiles, n_tx, tile_h, tile_w, cap, d, threads,
                                        blocks_per_tile, g_table, stream);
}

int raster_bwd_f64(const void* slot_map, const void* g_vals, const void* counts, int n_tiles, int n_tx, int tile_h,
                   int tile_w, int cap, int d, int threads, int blocks_per_tile, void* g_table, void* stream) {
  return deodr::raster_bwd_launch<double>(slot_map, g_vals, counts, n_tiles, n_tx, tile_h, tile_w, cap, d, threads,
                                        blocks_per_tile, g_table, stream);
}

}  // extern "C"
