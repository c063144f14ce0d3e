// Quad-window bilinear blend of the quad-granular texture fetch: forward
// (blend each pixel's 4 taps from its quad's 8×8 texel window) and backward
// (dense window cotangent and the cotangents of the weights).
//
// Replaces deodr_tpu/ops/pallas/quad_blend_kernel.py: _fwd_kernel (called by
// _quad_blend_call) and _bwd_kernel (called by _quad_blend_bwd).
//
// Layouts (Q quads, 4 pixels per quad, C channels; see quad_blend_kernel.py):
//   win    (Q, 64·C) row-major, entry (r·8 + x)·C + c = window texel (r, x), channel c
//   dv, du (Q, 4)    int32 tap offsets, clamped to 0..6 here
//   ev, eu (Q, 4)    weights of the second row and column
//   out    (Q, 4, C)
//   d_win  (Q, 64·C) every entry written, 0 where no tap reads
//   d_ev, d_eu (Q, 4)
//
// What bounds it on the H100. The forward reads 4 taps of C values per
// pixel from a 64·C row per quad and writes C values per pixel: a few float
// operations per byte, so it is bound by bytes (the coefficients, the taps
// it reads and its output). The backward must write the dense Q·64·C window
// cotangent, 16 times the size of its input cotangent, so it is bound by
// that write: 24.8 MB at the duck's 32256 quads, 7.4 µs at 3.35 TB/s.
//
// The forward. The TPU kernel's soft one-hot over all 64 window positions
// (quads on the lane axis, a transposed window table) exists because a TPU
// has no cheap gather; here one thread per pixel reads its 4 taps directly
// and blends them in the operation order of bilinear_blend, so kernel and
// plain version agree bit for bit (compiled with -fmad=false). It is a
// template on C, so all 4·C tap loads of a pixel issue together once its
// offsets arrive; its first design looped over a run-time C, one round of
// loads per channel. One thread per quad instead (16-byte coefficient
// loads, 16·C taps and 4·C outputs a thread) was twice as slow: a warp's
// lanes then read 32 windows 64·C values apart, where four neighbouring
// pixel threads share one window. Measured (tools/fwd_scan.py, NVIDIA H100
// 80GB HBM3, 700 W, the duck's 32256 quads at C = 3, float32, device time
// per call): 0.0030 ms at 64 threads a block, 0.0031-0.0032 at 128 and
// 256, 0.0042 at 32; one thread a quad 0.0065-0.0082; the first design
// 0.0039 and grid_sample 0.0040 in the same calls; bound 0.0018.
//
// The backward. Its first design gave each quad to one warp, whose lanes
// walked the 64·C window entries and, for each entry, searched the quad's
// 16 (tap, pixel) pairs for the ones that read it: 3072 compare steps per
// quad at C = 3 to produce 48 terms, a runtime division per entry, and
// d_ev/d_eu from 4 lanes of each warp. It was bound by instruction issue
// and latency: 0.0477 ms of device time at the duck's quads, slower than
// grid_sample's backward on the same function (0.0402). This design
// scatters instead of searching. It is a template on C, so the channel
// loops unroll and no division is left. A block owns 32 consecutive quads
// and stages their d_win rows (64·C·32 values, 24 KB at C = 3 in float32,
// each row padded by 16 bytes so that neighbouring quads' rows start on
// different banks) in shared memory, zeroed with 16-byte stores. One
// thread per (quad, channel) adds its quad's 16 terms w[k][p]·ct[p][ch]
// into the entries they hit, tap k outer and pixel p inner: the order of
// the plain version's index_add_. That thread alone owns its quad's
// entries of its channel, so there are no atomics and the sum's order is
// fixed. One thread per pixel meanwhile computes d_ev and d_eu from its 4
// taps, summed over channels in order. The block's rows are one contiguous
// range of d_win, written from shared memory with coalesced 16-byte
// stores, zeros included: the write the bound is made of.
//
// Measured (chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W, the duck's
// 32256 quads at C = 3, float32, two runs): 0.0122-0.0124 ms of device time
// per call against a bound of 0.0096 ms and grid_sample's backward at
// 0.0397-0.0399 ms.

#include "common.cuh"

namespace deodr {

constexpr int kQuadsPerBlock = 32;                   // backward: quads staged per block
constexpr int kQuadBwdThreads = 4 * kQuadsPerBlock;  // one per pixel, and ≥ one per (quad, channel) for C ≤ 4

template <typename T>
struct Vec16;  // 16 bytes of T, for the zeroing and the dense write
template <>
struct Vec16<float> {
  using type = float4;
  static __device__ __forceinline__ float4 zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
};
template <>
struct Vec16<double> {
  using type = double2;
  static __device__ __forceinline__ double2 zero() { return make_double2(0.0, 0.0); }
};

// The forward's block: 64 threads, one per pixel (16 quads); the fastest of 32, 64, 128 and 256.
constexpr int kQuadFwdThreads = 64;

template <typename T, int C>
__global__ void __launch_bounds__(kQuadFwdThreads)
    quad_blend_fwd_kernel(const T* __restrict__ win, const int* __restrict__ dv, const int* __restrict__ du,
                          const T* __restrict__ ev, const T* __restrict__ eu, int n_quads, T* __restrict__ out) {
  const int i = blockIdx.x * kQuadFwdThreads + threadIdx.x;  // pixel 4q + p
  if (i >= 4 * n_quads) return;
  const int q = i >> 2;
  const T* tap = win + (size_t)q * 64 * C + (min(max(dv[i], 0), 6) * 8 + min(max(du[i], 0), 6)) * C;
  const T wv = ev[i], wu = eu[i];
  T t[4][C];  // t00, t10, t01, t11: all 4·C loads issue before the first blend
#pragma unroll
  for (int ch = 0; ch < C; ++ch) {
    t[0][ch] = __ldg(tap + ch);
    t[1][ch] = __ldg(tap + C + ch);
    t[2][ch] = __ldg(tap + 8 * C + ch);
    t[3][ch] = __ldg(tap + 9 * C + ch);
  }
#pragma unroll
  for (int ch = 0; ch < C; ++ch)
    out[(size_t)i * C + ch] =
        (((T)1 - wu) * t[0][ch] + wu * t[1][ch]) * ((T)1 - wv) + (((T)1 - wu) * t[2][ch] + wu * t[3][ch]) * wv;
}

template <typename T, int C>
__global__ void __launch_bounds__(kQuadBwdThreads)
    quad_blend_bwd_kernel(const T* __restrict__ win, const int* __restrict__ dv, const int* __restrict__ du,
                          const T* __restrict__ ev, const T* __restrict__ eu, const T* __restrict__ ct, int n_quads,
                          T* __restrict__ d_win, T* __restrict__ d_ev, T* __restrict__ d_eu) {
  using V = typename Vec16<T>::type;
  constexpr int kRow = 64 * C;
  constexpr int kRowV = kRow * (int)sizeof(T) / 16;  // 16-byte vectors per row
  constexpr int kStrideV = kRowV + 1;                // one vector of padding staggers the rows' banks
  constexpr int kStride = kStrideV * 16 / (int)sizeof(T);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* acc = reinterpret_cast<T*>(smem_raw);  // the block's d_win rows, kStride apart
  V* acc_v = reinterpret_cast<V*>(smem_raw);
  const int q0 = blockIdx.x * kQuadsPerBlock;
  const int nq = min(kQuadsPerBlock, n_quads - q0);
  const int t = threadIdx.x;
  for (int i = t; i < nq * kStrideV; i += kQuadBwdThreads) acc_v[i] = Vec16<T>::zero();
  __syncthreads();

  if (t < nq * C) {  // thread (quad lq, channel ch) scatters its quad's 16 terms
    const int lq = t / C, ch = t - lq * C;
    const int q = q0 + lq;
    int pos[4];
    T w[4][4], g[4];  // w[tap][pixel]: t00, t10, t01, t11
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int i = 4 * q + p;
      pos[p] = min(max(dv[i], 0), 6) * 8 + min(max(du[i], 0), 6);
      const T wv = ev[i], wu = eu[i];
      w[0][p] = ((T)1 - wu) * ((T)1 - wv);
      w[1][p] = wu * ((T)1 - wv);
      w[2][p] = ((T)1 - wu) * wv;
      w[3][p] = wu * wv;
      g[p] = ct[(size_t)i * C + ch];
    }
    T* row = acc + lq * kStride + ch;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int off = (k >> 1) * 8 + (k & 1);
#pragma unroll
      for (int p = 0; p < 4; ++p) row[(pos[p] + off) * C] += w[k][p] * g[p];
    }
  }
  if (t < 4 * nq) {  // pixel 4·q0 + t: the cotangents of its weights
    const int i = 4 * q0 + t;
    const int q = i >> 2;
    const T wv = ev[i], wu = eu[i];
    const T* tap = win + (size_t)q * kRow + (min(max(dv[i], 0), 6) * 8 + min(max(du[i], 0), 6)) * C;
    const T* gc = ct + (size_t)i * C;
    T a_ev = (T)0, a_eu = (T)0;
#pragma unroll
    for (int ch = 0; ch < C; ++ch) {
      const T t00 = tap[ch], t10 = tap[C + ch], t01 = tap[8 * C + ch], t11 = tap[9 * C + ch];
      const T top = ((T)1 - wu) * t00 + wu * t10;
      const T bot = ((T)1 - wu) * t01 + wu * t11;
      a_ev += gc[ch] * (bot - top);
      a_eu += gc[ch] * ((t10 - t00) * ((T)1 - wv) + (t11 - t01) * wv);
    }
    d_ev[i] = a_ev;
    d_eu[i] = a_eu;
  }
  __syncthreads();
  V* out_v = reinterpret_cast<V*>(d_win + (size_t)q0 * kRow);
  for (int i = t; i < nq * kRowV; i += kQuadBwdThreads) {
    const int r = i / kRowV;
    out_v[i] = acc_v[r * kStrideV + (i - r * kRowV)];
  }
}

template <typename T, int C>
static int quad_blend_fwd_launch_c(const void* win, const void* dv, const void* du, const void* ev, const void* eu,
                                   int n_quads, void* out, void* stream) {
  quad_blend_fwd_kernel<T, C><<<(4 * n_quads + kQuadFwdThreads - 1) / kQuadFwdThreads, kQuadFwdThreads, 0,
                                (cudaStream_t)stream>>>((const T*)win, (const int*)dv, (const int*)du, (const T*)ev,
                                                        (const T*)eu, n_quads, (T*)out);
  return (int)cudaGetLastError();
}

template <typename T>
static int quad_blend_fwd_launch(const void* win, const void* dv, const void* du, const void* ev, const void* eu,
                                 int n_quads, int c, void* out, void* stream) {
  if (n_quads == 0) return 0;
  switch (c) {
    case 1: return quad_blend_fwd_launch_c<T, 1>(win, dv, du, ev, eu, n_quads, out, stream);
    case 2: return quad_blend_fwd_launch_c<T, 2>(win, dv, du, ev, eu, n_quads, out, stream);
    case 3: return quad_blend_fwd_launch_c<T, 3>(win, dv, du, ev, eu, n_quads, out, stream);
    case 4: return quad_blend_fwd_launch_c<T, 4>(win, dv, du, ev, eu, n_quads, out, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T, int C>
static int quad_blend_bwd_launch_c(const void* win, const void* dv, const void* du, const void* ev, const void* eu,
                                   const void* ct, int n_quads, void* d_win, void* d_ev, void* d_eu, void* stream) {
  const size_t smem = (size_t)kQuadsPerBlock * (64 * C * sizeof(T) + 16);
  const cudaError_t err = reserve_smem(quad_blend_bwd_kernel<T, C>, smem);
  if (err != cudaSuccess) return (int)err;
  quad_blend_bwd_kernel<T, C>
      <<<(n_quads + kQuadsPerBlock - 1) / kQuadsPerBlock, kQuadBwdThreads, smem, (cudaStream_t)stream>>>(
          (const T*)win, (const int*)dv, (const int*)du, (const T*)ev, (const T*)eu, (const T*)ct, n_quads,
          (T*)d_win, (T*)d_ev, (T*)d_eu);
  return (int)cudaGetLastError();
}

template <typename T>
static int quad_blend_bwd_launch(const void* win, const void* dv, const void* du, const void* ev, const void* eu,
                                 const void* ct, int n_quads, int c, void* d_win, void* d_ev, void* d_eu,
                                 void* stream) {
  if (n_quads == 0) return 0;
  switch (c) {
    case 1: return quad_blend_bwd_launch_c<T, 1>(win, dv, du, ev, eu, ct, n_quads, d_win, d_ev, d_eu, stream);
    case 2: return quad_blend_bwd_launch_c<T, 2>(win, dv, du, ev, eu, ct, n_quads, d_win, d_ev, d_eu, stream);
    case 3: return quad_blend_bwd_launch_c<T, 3>(win, dv, du, ev, eu, ct, n_quads, d_win, d_ev, d_eu, stream);
    case 4: return quad_blend_bwd_launch_c<T, 4>(win, dv, du, ev, eu, ct, n_quads, d_win, d_ev, d_eu, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace deodr

extern "C" {

int quad_blend_fwd_f32(const void* win, const void* dv, const void* du, const void* ev, const void* eu, int n_quads,
                       int c, void* out, void* stream) {
  return deodr::quad_blend_fwd_launch<float>(win, dv, du, ev, eu, n_quads, c, out, stream);
}

int quad_blend_fwd_f64(const void* win, const void* dv, const void* du, const void* ev, const void* eu, int n_quads,
                       int c, void* out, void* stream) {
  return deodr::quad_blend_fwd_launch<double>(win, dv, du, ev, eu, n_quads, c, out, stream);
}

int quad_blend_bwd_f32(const void* win, const void* dv, const void* du, const void* ev, const void* eu,
                       const void* ct, int n_quads, int c, void* d_win, void* d_ev, void* d_eu, void* stream) {
  return deodr::quad_blend_bwd_launch<float>(win, dv, du, ev, eu, ct, n_quads, c, d_win, d_ev, d_eu, stream);
}

int quad_blend_bwd_f64(const void* win, const void* dv, const void* du, const void* ev, const void* eu,
                       const void* ct, int n_quads, int c, void* d_win, void* d_ev, void* d_eu, void* stream) {
  return deodr::quad_blend_bwd_launch<double>(win, dv, du, ev, eu, ct, n_quads, c, d_win, d_ev, d_eu, stream);
}

}  // extern "C"
