// Tiled solid pass of the rasterizer: forward (z-argmin winner and the
// winner's affine attribute planes) and backward (per-slot reduction of the
// pixel cotangents against (x, y, 1)).
//
// Replaces deodr_tpu/ops/pallas/raster_kernel.py: _fwd_kernel (called by
// _raster_fwd_call) and _bwd_kernel (called by _raster_bwd).
//
// What bounds it on the H100. Forward: every pixel of a tile visits every
// slot binned to the tile, ~30 float operations per visit (two sub-triangle
// coverage tests, bbox, depth plane, compare), and writes 8 + 4·D bytes.
// At the bench scene (512², 200 triangles, 48×128 tiles, tens of slots per
// tile) that is a few hundred million operations against a few MB written,
// so it is bound by operations, far from the memory rate. Backward: reads
// one slot id and D cotangents per pixel and does 3·D products, bound by
// bytes (about 10 MB on the duck, 3 µs at 3.35 TB/s); what holds it back is
// the reduction: many pixels adding into few table entries.
//
// The forward. One thread per pixel, one block of 256 pixels of one tile
// (grid = tiles × pixel chunks), so a warp covers 32 neighbouring pixels of
// one row and every load and store is coalesced. It stages the tile's setup
// rows in shared memory in chunks of 64 slots and keeps only (best z, best
// slot) in registers over the ascending slot loop; a strict < keeps the
// lowest slot on ties. The winner's attribute planes are evaluated once
// after the loop. The file is compiled with -fmad=false, so each plane
// rounds like the plain PyTorch version, and without fast math, so the
// right-edge test "plane > -FLT_MIN" sees denormals. Slot pairing, the
// TPU's latency device, is not needed here.
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
constexpr int kChunk = 64;   // setup rows staged in shared memory at a time

template <typename T>
__global__ void __launch_bounds__(kThreads)
    raster_fwd_kernel(const T* __restrict__ setup, const T* __restrict__ affine, const int* __restrict__ counts,
                      int n_tx, int tile_h, int tile_w, int cap, int d, int* __restrict__ slot_map,
                      T* __restrict__ z_out, T* __restrict__ vals) {
  __shared__ T rows[kChunk * kSetupW];
  const int tile = blockIdx.x;
  const Pixel px = pixel_of(tile, n_tx, tile_h, tile_w);
  const T x = (T)px.x, y = (T)px.y;
  const int count = min(counts[tile], cap);
  const T neg_tiny = -Limits<T>::tiny();
  const T* tile_setup = setup + (size_t)tile * cap * kSetupW;

  T best_z = (T)INFINITY;
  int best = cap;
  for (int base = 0; base < count; base += kChunk) {
    const int n = min(kChunk, count - base);
    __syncthreads();
    for (int i = threadIdx.x; i < n * kSetupW; i += blockDim.x) rows[i] = tile_setup[(size_t)base * kSetupW + i];
    __syncthreads();
    for (int k = 0; k < n; ++k) {
      const T* r = rows + k * kSetupW;
      bool cov = false;
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const T* le = r + 4 + 3 * p;
        const T* re = r + 10 + 3 * p;
        const bool row_ok = (y >= r[p]) && (y <= r[2 + p]);
        const T plane_l = le[0] * x + (le[1] * y + le[2]);
        const T plane_r = re[0] * x + (re[1] * y + re[2]);
        cov = cov || (row_ok && plane_l > (T)0 && plane_r > neg_tiny);
      }
      cov = cov && x >= r[16] && x <= r[17];
      const T z = r[18] * x + (r[19] * y + r[20]);
      cov = cov && r[21] > (T)0.5 && isfinite(z);
      if (cov && z < best_z) {
        best_z = z;
        best = base + k;
      }
    }
  }
  if (!px.inside) return;
  const size_t plane = (size_t)gridDim.x * tile_h * tile_w;
  slot_map[px.offset] = best;
  z_out[px.offset] = best_z;
  const bool hit = best < cap;
  const T* a = affine + ((size_t)tile * cap + (hit ? best : 0)) * 3 * d;
  for (int j = 0; j < d; ++j) {
    vals[j * plane + px.offset] = hit ? a[j] * x + (a[d + j] * y + a[2 * d + j]) : (T)0;
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

template <typename T>
static int raster_fwd_launch(const void* setup, const void* affine, const void* counts, int n_tiles, int n_tx,
                             int tile_h, int tile_w, int cap, int d, void* slot_map, void* z, void* vals,
                             void* stream) {
  const int n_px = tile_h * tile_w;
  if (n_tiles == 0 || n_px == 0) return 0;
  const dim3 grid(n_tiles, (n_px + kThreads - 1) / kThreads);
  raster_fwd_kernel<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)setup, (const T*)affine, (const int*)counts, n_tx, tile_h, tile_w, cap, d, (int*)slot_map, (T*)z,
      (T*)vals);
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
                   int tile_w, int cap, int d, void* slot_map, void* z, void* vals, void* stream) {
  return deodr::raster_fwd_launch<float>(setup, affine, counts, n_tiles, n_tx, tile_h, tile_w, cap, d, slot_map, z,
                                         vals, stream);
}

int raster_fwd_f64(const void* setup, const void* affine, const void* counts, int n_tiles, int n_tx, int tile_h,
                   int tile_w, int cap, int d, void* slot_map, void* z, void* vals, void* stream) {
  return deodr::raster_fwd_launch<double>(setup, affine, counts, n_tiles, n_tx, tile_h, tile_w, cap, d, slot_map, z,
                                          vals, stream);
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
