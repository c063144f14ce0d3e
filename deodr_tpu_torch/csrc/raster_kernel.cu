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
// bytes; its hazard is atomic contention, a tile owned by one triangle
// adding every pixel into the same row.
//
// What this first design does. One thread per pixel, one block of 256
// pixels of one tile (grid = tiles × pixel chunks), so a warp covers 32
// neighbouring pixels of one row and every load and store is coalesced.
// The forward stages the tile's setup rows in shared memory in chunks of 64
// slots and keeps only (best z, best slot) in registers over the ascending
// slot loop; a strict < keeps the lowest slot on ties. The winner's
// attribute planes are evaluated once after the loop. The backward reduces
// in a warp first when all 32 pixels share a slot (the common case inside a
// triangle), then in shared-memory accumulators per block, and issues one
// global atomic per block and table entry. The file is compiled with
// -fmad=false, so each plane rounds like the plain PyTorch version, and
// without fast math, so the right-edge test "plane > -FLT_MIN" sees
// denormals. Slot pairing, the TPU's latency device, is not needed here.

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
    raster_bwd_kernel(const int* __restrict__ slot_map, const T* __restrict__ g_vals, const int* __restrict__ counts,
                      int n_tx, int tile_h, int tile_w, int cap, int d, T* __restrict__ g_table) {
  extern __shared__ unsigned char smem_raw[];
  T* acc = reinterpret_cast<T*>(smem_raw);  // count × 3d per-block partial sums
  const int tile = blockIdx.x;
  const int count = min(counts[tile], cap);
  const int width = 3 * d;
  const int n_acc = count * width;
  for (int i = threadIdx.x; i < n_acc; i += blockDim.x) acc[i] = (T)0;
  __syncthreads();

  const Pixel px = pixel_of(tile, n_tx, tile_h, tile_w);
  const size_t plane = (size_t)gridDim.x * tile_h * tile_w;
  const T x = (T)px.x, y = (T)px.y;
  const int s = px.inside ? slot_map[px.offset] : cap;
  const bool hit = s < count;
  const int s0 = __shfl_sync(kFullMask, s, 0);
  const bool uniform = __all_sync(kFullMask, s == s0);
  const int lane = threadIdx.x & 31;
  for (int j = 0; j < d; ++j) {
    const T g = hit ? g_vals[j * plane + px.offset] : (T)0;
    T vx = g * x, vy = g * y, vc = g;
    if (uniform) {
      if (s0 < count) {
        vx = warp_sum(vx);
        vy = warp_sum(vy);
        vc = warp_sum(vc);
        if (lane == 0) {
          atomicAdd(&acc[s0 * width + j], vx);
          atomicAdd(&acc[s0 * width + d + j], vy);
          atomicAdd(&acc[s0 * width + 2 * d + j], vc);
        }
      }
    } else if (hit) {
      atomicAdd(&acc[s * width + j], vx);
      atomicAdd(&acc[s * width + d + j], vy);
      atomicAdd(&acc[s * width + 2 * d + j], vc);
    }
  }
  __syncthreads();
  T* out = g_table + (size_t)tile * cap * width;
  for (int i = threadIdx.x; i < n_acc; i += blockDim.x) {
    const T v = acc[i];
    if (v != (T)0) atomicAdd(&out[i], v);
  }
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
                             int tile_h, int tile_w, int cap, int d, void* g_table, void* stream) {
  const int n_px = tile_h * tile_w;
  if (n_tiles == 0 || n_px == 0 || cap == 0) return 0;
  const size_t smem = (size_t)cap * 3 * d * sizeof(T);
  const cudaError_t err = reserve_smem(raster_bwd_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n_tiles, (n_px + kThreads - 1) / kThreads);
  raster_bwd_kernel<T><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const int*)slot_map, (const T*)g_vals, (const int*)counts, n_tx, tile_h, tile_w, cap, d, (T*)g_table);
  return (int)cudaGetLastError();
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
                   int tile_w, int cap, int d, void* g_table, void* stream) {
  return deodr::raster_bwd_launch<float>(slot_map, g_vals, counts, n_tiles, n_tx, tile_h, tile_w, cap, d, g_table,
                                         stream);
}

int raster_bwd_f64(const void* slot_map, const void* g_vals, const void* counts, int n_tiles, int n_tx, int tile_h,
                   int tile_w, int cap, int d, void* g_table, void* stream) {
  return deodr::raster_bwd_launch<double>(slot_map, g_vals, counts, n_tiles, n_tx, tile_h, tile_w, cap, d, g_table,
                                          stream);
}

}  // extern "C"
