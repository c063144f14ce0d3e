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
// cotangent, which is 16 times its output's size, so it too is bound by
// bytes, and by that write above all.
//
// What this design does. The TPU kernel's soft one-hot over all 64 window
// positions (quads on the lane axis, a transposed window table) exists
// because a TPU has no cheap gather; here the forward is one thread per
// pixel that reads its 4 taps directly and blends them in the operation
// order of bilinear_blend, so kernel and plain version agree bit for bit
// (compiled with -fmad=false). The backward gives each quad to one warp:
// the 32 lanes walk the quad's 64·C window entries with consecutive
// addresses (coalesced stores, zeros included) and sum, for each entry, the
// terms of the taps that read it, tap by tap and then pixel by pixel, the
// order of the plain version's index_add_. A quad's row belongs to one warp
// alone, so no atomics are needed. Lanes 0..3 then compute d_ev and d_eu of
// the quad's 4 pixels.

#include "common.cuh"

namespace deodr {

constexpr int kQuadThreads = 128;  // backward: 4 warps, one quad each

template <typename T>
__global__ void __launch_bounds__(kThreads)
    quad_blend_fwd_kernel(const T* __restrict__ win, const int* __restrict__ dv, const int* __restrict__ du,
                          const T* __restrict__ ev, const T* __restrict__ eu, int n_quads, int c,
                          T* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;  // pixel 4q + p
  if (i >= 4 * n_quads) return;
  const int q = i >> 2;
  const int r = min(max(dv[i], 0), 6), x = min(max(du[i], 0), 6);
  const T wv = ev[i], wu = eu[i];
  const T* w = win + (size_t)q * 64 * c + (size_t)(r * 8 + x) * c;
  for (int ch = 0; ch < c; ++ch) {
    const T t00 = w[ch], t10 = w[c + ch], t01 = w[8 * c + ch], t11 = w[9 * c + ch];
    out[(size_t)i * c + ch] = (((T)1 - wu) * t00 + wu * t10) * ((T)1 - wv) + (((T)1 - wu) * t01 + wu * t11) * wv;
  }
}

template <typename T>
__global__ void __launch_bounds__(kQuadThreads)
    quad_blend_bwd_kernel(const T* __restrict__ win, const int* __restrict__ dv, const int* __restrict__ du,
                          const T* __restrict__ ev, const T* __restrict__ eu, const T* __restrict__ ct, int n_quads,
                          int c, T* __restrict__ d_win, T* __restrict__ d_ev, T* __restrict__ d_eu) {
  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x * (kQuadThreads / 32) + (threadIdx.x >> 5);
  if (q >= n_quads) return;
  int rr[4], xx[4];
  T w[4][4];  // [tap][pixel]: t00, t10, t01, t11
  for (int p = 0; p < 4; ++p) {
    const int i = 4 * q + p;
    rr[p] = min(max(dv[i], 0), 6);
    xx[p] = min(max(du[i], 0), 6);
    const T wv = ev[i], wu = eu[i];
    w[0][p] = ((T)1 - wu) * ((T)1 - wv);
    w[1][p] = wu * ((T)1 - wv);
    w[2][p] = ((T)1 - wu) * wv;
    w[3][p] = wu * wv;
  }
  const T* g = ct + (size_t)q * 4 * c;
  const int width = 64 * c;
  T* out = d_win + (size_t)q * width;
  for (int j = lane; j < width; j += 32) {
    const int pos = j / c, ch = j - pos * c;
    const int r = pos >> 3, x = pos & 7;
    T acc = (T)0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int dr = k >> 1, dx = k & 1;
      for (int p = 0; p < 4; ++p)
        if (rr[p] + dr == r && xx[p] + dx == x) acc += w[k][p] * g[p * c + ch];
    }
    out[j] = acc;
  }
  if (lane < 4) {
    const int p = lane, i = 4 * q + p;
    const T wv = ev[i], wu = eu[i];
    const T* t = win + (size_t)q * width + (size_t)(rr[p] * 8 + xx[p]) * c;
    T a_ev = (T)0, a_eu = (T)0;
    for (int ch = 0; ch < c; ++ch) {
      const T t00 = t[ch], t10 = t[c + ch], t01 = t[8 * c + ch], t11 = t[9 * c + ch];
      const T top = ((T)1 - wu) * t00 + wu * t10;
      const T bot = ((T)1 - wu) * t01 + wu * t11;
      const T gc = g[p * c + ch];
      a_ev += gc * (bot - top);
      a_eu += gc * ((t10 - t00) * ((T)1 - wv) + (t11 - t01) * wv);
    }
    d_ev[i] = a_ev;
    d_eu[i] = a_eu;
  }
}

template <typename T>
static int quad_blend_fwd_launch(const void* win, const void* dv, const void* du, const void* ev, const void* eu,
                                 int n_quads, int c, void* out, void* stream) {
  if (n_quads == 0) return 0;
  const int n = 4 * n_quads;
  quad_blend_fwd_kernel<T><<<(n + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)win, (const int*)dv, (const int*)du, (const T*)ev, (const T*)eu, n_quads, c, (T*)out);
  return (int)cudaGetLastError();
}

template <typename T>
static int quad_blend_bwd_launch(const void* win, const void* dv, const void* du, const void* ev, const void* eu,
                                 const void* ct, int n_quads, int c, void* d_win, void* d_ev, void* d_eu,
                                 void* stream) {
  if (n_quads == 0) return 0;
  constexpr int per_block = kQuadThreads / 32;
  quad_blend_bwd_kernel<T><<<(n_quads + per_block - 1) / per_block, kQuadThreads, 0, (cudaStream_t)stream>>>(
      (const T*)win, (const int*)dv, (const int*)du, (const T*)ev, (const T*)eu, (const T*)ct, n_quads, c,
      (T*)d_win, (T*)d_ev, (T*)d_eu);
  return (int)cudaGetLastError();
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
