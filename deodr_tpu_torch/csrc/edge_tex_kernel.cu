// Tiled silhouette edge-overdraw pass for textured and mixed scenes: the
// painter's blend of edge_kernel.cu where a slot's band colour is either its
// affine colour planes (a plain slot) or a bilinear texture sample times an
// affine Gouraud shade (a textured slot), forward and backward.
//
// Replaces deodr_tpu/ops/pallas/edge_tex_kernel.py: _fwd_kernel (called by
// _tex_fwd_call) and _bwd_kernel (called by _tex_bwd).
//
// What is not carried over. The TPU has no vector gather, so its kernel
// receives a stack of per-edge texture windows, samples them with soft
// one-hot matrix contractions and sums window gradients that XLA scatters
// back into the texture afterwards. Here every masked pixel of a textured
// slot reads its four taps straight from the texture (channel-last,
// (tex_h, tex_w, C); a 512² RGB float32 atlas is 3 MB and stays in the 50 MB
// L2) and the backward adds the four texel gradients per channel with
// atomicAdd into a texture-shaped buffer. The border rules are
// bilinear_sample's, against the full texture: fu = floor(u); the weight
// eu is 0 where fu < 0, 1 where fu > tex_w − 2, else u − fu; taps at
// clamp(fu, 0, tex_w − 2); a clamped coordinate gets no gradient.
//
// What bounds it on the H100. A band covers few of its tile's pixels (its
// clip planes and y range hold at 0.2 % of the duck's (pixel, slot) pairs,
// edge_kernel.covered_visits), each ~33 float operations for the band
// test; only the few pixels inside a band pay for the fetch (three more
// planes, 4·C loads) and, in the backward, for 4·C global atomics. The
// bytes are a handful of planes per pixel, the table, the taps of the
// painted pixels only (a few kB on a thin silhouette, not the texture) and,
// in the backward, the dense texture gradient that the caller zero-fills.
// On the duck the frame's planes make the bytes the larger bound, a few
// microseconds, below a launch. The hazards are the latency of the
// dependent texel loads inside the sequential slot loop and atomic
// contention where many band pixels share a texel (magnified textures).
//
// The forward. Its first design had one thread per pixel in blocks of 256
// pixels of one tile, rows staged 32 at a time with plain loads, and every
// pixel tested every slot with a chain of branches: 0.0202 ms of device
// time on the duck (NVIDIA H100 80GB HBM3, 700 W), 7.6× its bound. This
// design runs on the forward frame of common.cuh (fwd_chunks), as the
// raster and edge forward kernels do: a warp owns a region (16 × 2 patches,
// P = kTexFwdPixels = 1 pixel a lane), tests a staged 64-row chunk's bands
// against the region's rectangle two a lane (band_may_cover: the textured
// row keeps the band planes in the same columns, so the cull is exact here
// too) and walks the kept ones in painter's order, each lane holding its
// pixel's C colour planes (or one residual plane), z-buffer and
// observations in registers and storing them once at the end; a kept slot
// is load_slot (the branch-free band test and, inside the band, the
// footprint, shade and 4·C texel loads) then the blend. Measured
// (tools/fwd_scan.py, same card, float32, device time per call): 0.0095 ms
// on the duck (bound 0.0027). Loading the next kept slot's inputs before
// the current one blends, as the backward does, took 0.0101-0.0137 ms at
// every register budget tried: on the duck only 1812 (pixel, slot) pairs
// fetch texels, so there is little latency to hide and the second slot's
// registers cost more than it; two pixels a lane took 0.0130.
//
// The backward. It runs edge_bwd_frame (common.cuh), as edge_kernel.cu's
// backward does (one cluster per tile writing whole rows, 16 × 2 patches a
// warp, 64-row chunks culled a region at a time, one butterfly per warp and
// slot). At one pixel a lane it splits each slot in two: load_slot (band test
// and, inside the band, the footprint, shade and 4·C texel loads) for the
// next slot the warp walks is issued before apply_slot (the un-blend, the
// texel atomics and the moments) of the current one, so the dependent texel
// loads' latency overlaps the carried chain. A plain slot owns the moment
// columns of t and its colour planes, a textured slot those of t, u, v and
// the shade, in its row [g_t 3 | g_a 3C | g_uc 3 | g_vc 3 | g_lc 3]; the
// columns a slot does not own, and rows ≥ count, are written 0. g_tex keeps
// its atomics (the caller zero-fills it): the order of a texel's adds may
// change its last bit from call to call, g_rows does not change. Measured
// (chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W) it took 0.037 ms on
// the duck against the first design's 0.041, and 0.031 once band_mask lost
// its branches (tools/fwd_scan.py, same card): its 300 tiles take 4 blocks
// each, about two waves of blocks whose latency chain (count, rows, walk,
// cluster barrier, remote reads) costs microseconds even on the 177 empty and
// the many light tiles, and the fullest tiles (65 and 68 slots) cross a
// 64-row chunk. Tap indices are computed for masked pixels only and clamped
// with fmin/fmax, which drop a NaN, so no index can leave the texture
// whatever an inactive row carries. Compiled with -fmad=false: u, v and the
// shade plane round as in the plain PyTorch version, so both read the same
// texels.

#include "common.cuh"

namespace deodr {

// Bilinear footprint of one sample: offset of the top-left tap, the two
// weights, and whether each coordinate is differentiable (not clamped).
template <typename T>
struct Footprint {
  int i00;
  T eu, ev;
  bool gate_u, gate_v;
};

template <typename T>
__device__ __forceinline__ Footprint<T> footprint_of(T u, T v, int tex_h, int tex_w) {
  Footprint<T> f;
  const T fu = floor(u), fv = floor(v);
  const T u_max = (T)(tex_w - 2), v_max = (T)(tex_h - 2);
  f.eu = fu < (T)0 ? (T)0 : (fu > u_max ? (T)1 : u - fu);
  f.ev = fv < (T)0 ? (T)0 : (fv > v_max ? (T)1 : v - fv);
  f.gate_u = fu >= (T)0 && fu <= u_max;
  f.gate_v = fv >= (T)0 && fv <= v_max;
  const int iu = (int)fmin(fmax(fu, (T)0), u_max);
  const int iv = (int)fmin(fmax(fv, (T)0), v_max);
  f.i00 = iv * tex_w + iu;
  return f;
}

// Column offsets of the textured row after the 25 + 3C untextured columns.
constexpr int kTexU = 0, kTexV = 3, kTexL = 6, kTexFlag = 9, kTexExtra = 10;

// The half of one slot at one pixel that does not depend on the carried
// buffer: the band test and, inside the band, a plain slot's colour planes
// or a textured slot's shade, footprint and 4·C texels. The backward loads
// slot k − 1's while slot k un-blends, so that the texel loads' latency
// overlaps that work instead of lengthening the serial chain.
template <typename T, int C>
struct SlotInputs {
  bool mask;
  T t;
  T a[C];  // plain slot: band colour
  T lum;   // textured slot: shade, footprint, taps t00, t10, t01, t11
  Footprint<T> f;
  T tap[4][C];
};

// `may`: the lane's pixel is inside the tile (its warp's region passed
// band_may_cover); else the slot does not paint it.
template <typename T, int C>
__device__ __forceinline__ void load_slot(const T* r, bool textured, bool may, T x, T y, T zb,
                                          const T* __restrict__ tex, int tex_h, int tex_w, SlotInputs<T, C>& s) {
  constexpr int W0 = 25 + 3 * C;
  s.mask = band_mask<T, C>(r, x, y, zb, s.t) & may;
  if (!s.mask) return;
  if (textured) {
    const T u = plane3(r + W0 + kTexU, x, y);
    const T v = plane3(r + W0 + kTexV, x, y);
    s.lum = plane3(r + W0 + kTexL, x, y);
    s.f = footprint_of(u, v, tex_h, tex_w);
    const T* t00 = tex + (size_t)s.f.i00 * C;
    const T* t01 = t00 + (size_t)tex_w * C;
#pragma unroll
    for (int ch = 0; ch < C; ++ch) {
      s.tap[0][ch] = __ldg(t00 + ch);
      s.tap[1][ch] = __ldg(t00 + C + ch);
      s.tap[2][ch] = __ldg(t01 + ch);
      s.tap[3][ch] = __ldg(t01 + C + ch);
    }
  } else {
#pragma unroll
    for (int ch = 0; ch < C; ++ch) s.a[ch] = plane3(r + 21 + 3 * ch, x, y);
  }
}

// The carried half, at a masked pixel: un-blends the pixel's buffer and
// cotangent by the slot, adds the moments of the slot's gradient quantities
// to v (t, then the C colour planes of a plain slot, or u, v and the shade
// of a textured one) and a textured slot's texel gradients to g_tex.
template <typename T, int C, bool kErr>
__device__ __forceinline__ void apply_slot(const SlotInputs<T, C>& s, bool textured, const T* ob, T x, T y, int tex_w,
                                           T* buf, T* gb, T* __restrict__ g_tex, T (&v)[kMoments]) {
  T g_a[C];
  if (!textured) {
    const T g_t = unblend<T, C, kErr>(s.a, ob, s.t, buf, gb, g_a);
    add_moments(v, g_t, x, y);
#pragma unroll
    for (int ch = 0; ch < C; ++ch) add_moments(v + 3 + 3 * ch, g_a[ch], x, y);
    return;
  }
  const T one_eu = (T)1 - s.f.eu, one_ev = (T)1 - s.f.ev;
  T a[C], sample[C], d_u[C], d_v[C];
#pragma unroll
  for (int ch = 0; ch < C; ++ch) {
    const T t00 = s.tap[0][ch], t10 = s.tap[1][ch], t01 = s.tap[2][ch], t11 = s.tap[3][ch];
    const T top = one_eu * t00 + s.f.eu * t10;
    const T bot = one_eu * t01 + s.f.eu * t11;
    sample[ch] = top * one_ev + bot * s.f.ev;
    d_u[ch] = (t10 - t00) * one_ev + (t11 - t01) * s.f.ev;
    d_v[ch] = bot - top;
    a[ch] = sample[ch] * s.lum;
  }
  const T g_t = unblend<T, C, kErr>(a, ob, s.t, buf, gb, g_a);
  const size_t o00 = (size_t)s.f.i00 * C, o01 = o00 + (size_t)tex_w * C;
  T g_u = (T)0, g_v = (T)0, g_lum = (T)0;
#pragma unroll
  for (int ch = 0; ch < C; ++ch) {
    g_lum = g_lum + g_a[ch] * sample[ch];
    const T g_s = g_a[ch] * s.lum;
    g_u = g_u + g_s * d_u[ch];
    g_v = g_v + g_s * d_v[ch];
    atomicAdd(&g_tex[o00 + ch], g_s * (one_eu * one_ev));
    atomicAdd(&g_tex[o00 + C + ch], g_s * (s.f.eu * one_ev));
    atomicAdd(&g_tex[o01 + ch], g_s * (one_eu * s.f.ev));
    atomicAdd(&g_tex[o01 + C + ch], g_s * (s.f.eu * s.f.ev));
  }
  if (!s.f.gate_u) g_u = (T)0;
  if (!s.f.gate_v) g_v = (T)0;
  add_moments(v, g_t, x, y);
  add_moments(v + 3, g_u, x, y);
  add_moments(v + 6, g_v, x, y);
  add_moments(v + 9, g_lum, x, y);
}

// The band colour a[C] of a masked pixel from its slot's inputs: a plain
// slot's colour planes, or a textured slot's bilinear sample times its
// shade, in the plain version's operation order (bilinear_blend, then the
// shade).
template <typename T, int C>
__device__ __forceinline__ void band_color(const SlotInputs<T, C>& s, bool textured, T (&a)[C]) {
  if (!textured) {
#pragma unroll
    for (int ch = 0; ch < C; ++ch) a[ch] = s.a[ch];
    return;
  }
  const T one_eu = (T)1 - s.f.eu, one_ev = (T)1 - s.f.ev;
#pragma unroll
  for (int ch = 0; ch < C; ++ch) {
    const T top = one_eu * s.tap[0][ch] + s.f.eu * s.tap[1][ch];
    const T bot = one_eu * s.tap[2][ch] + s.f.eu * s.tap[3][ch];
    a[ch] = (top * one_ev + bot * s.f.ev) * s.lum;
  }
}

constexpr int kTexFwdPixels = 1;  // P, a lane's pixels in the forward: TEX_FWD_PIXELS in edge_tex_kernel.py

// Minimum blocks per SM 1 (not the default): ptxas then gives the kernel 84
// registers instead of 60 in float32 at C = 3, and it ran 6 % faster on the
// duck though fewer blocks fit an SM (0.0095 against 0.0101 ms in turns in
// one call, NVIDIA H100 80GB HBM3, 700 W, tools/fwd_scan.py).
template <typename T, int C, bool kErr>
__global__ void __launch_bounds__(kThreads, 1)
    edge_tex_fwd_kernel(const T* __restrict__ table, const int* __restrict__ counts, const T* __restrict__ zbuf,
                        const T* __restrict__ obs, const T* __restrict__ tex, const T* __restrict__ buf_in, int n_tx,
                        int tile_h, int tile_w, int cap, int tex_h, int tex_w, int blocks_per_tile,
                        T* __restrict__ buf_out) {
  constexpr int W0 = 25 + 3 * C;
  constexpr int W = W0 + kTexExtra;
  constexpr int NCH = kErr ? 1 : C;
  constexpr int P = kTexFwdPixels;
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
        const bool textured = r[W0 + kTexFlag] > (T)0.5;  // warp-uniform: every lane reads the same row
#pragma unroll
        for (int j = 0; j < P; ++j) {
          SlotInputs<T, C> s;
          load_slot(r, textured, ((inside >> j) & 1u) != 0, x[j], y[j], zb[j], tex, tex_h, tex_w, s);
          if (!s.mask) continue;
          T a[C];
          band_color(s, textured, a);
          blend<T, C, kErr>(a, ob[j], s.t, buf[j]);
        }
      });
#pragma unroll
  for (int j = 0; j < P; ++j) {
    if (!((inside >> j) & 1u)) continue;
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch) buf_out[ch * plane + offset[j]] = buf[j][ch];
  }
}

// Pixels a lane of the backward kernel holds at most. One pixel a lane
// walks with the next slot's inputs loaded ahead; a tile taller than 8
// blocks cover that way takes up to 3 a lane (edge_bwd_launch_shape picks
// how many), walked one after the other: on the duck's 48-row textured
// tiles that is 0.101 ms against 0.143 at one pixel a lane in 3 passes
// (loading a slot for all 3 pixels first took 22 more registers and no
// less time; NVIDIA H100 80GB HBM3, 700 W, tools/edge_bwd_scan.py).
constexpr int kTexBwdPixels = 3;

template <typename T, int C, bool kErr, int P>
__global__ void __launch_bounds__(kThreads)
    edge_tex_bwd_kernel(const T* __restrict__ table, const int* __restrict__ counts, const T* __restrict__ zbuf,
                        const T* __restrict__ obs, const T* __restrict__ tex, const T* __restrict__ buf_final,
                        const T* __restrict__ g_out, int n_tx, int tile_h, int tile_w, int cap, int tex_h, int tex_w,
                        int pixels, T* __restrict__ g_rows, T* __restrict__ g_buf0, T* __restrict__ g_tex) {
  constexpr int W0 = 25 + 3 * C;
  constexpr int W = W0 + kTexExtra;
  constexpr int GW = 12 + 3 * C;
  constexpr int GUV = 3 + 3 * C;  // first of the g_uc | g_vc | g_lc columns
  using Px = BwdPixels<T, C, kErr, P>;
  // painter's order, reversed, over the slots whose band may cover the region
  auto walk = [=](const T* rows, unsigned long long cover, Px& px, T* warp_acc) {
    if constexpr (P == 1) {  // the next slot's inputs loaded while the current one un-blends
      auto load = [&](int k, bool& textured, SlotInputs<T, C>& s) {
        const T* r = rows + k * W;
        textured = r[W0 + kTexFlag] > (T)0.5;  // uniform over the block
        load_slot(r, textured, px.in(0), px.x[0], px.y[0], px.zb[0], tex, tex_h, tex_w, s);
      };
      SlotInputs<T, C> cur, next;
      bool cur_tex = false, next_tex = false;
      int k = pop_highest(cover);
      if (k >= 0) load(k, cur_tex, cur);
      while (k >= 0) {
        const int k_next = pop_highest(cover);
        if (k_next >= 0) load(k_next, next_tex, next);
        T v[kMoments];
#pragma unroll
        for (int i = 0; i < kMoments; ++i) v[i] = (T)0;
        if (cur.mask)
          apply_slot<T, C, kErr>(cur, cur_tex, px.ob[0], px.x[0], px.y[0], tex_w, px.buf[0], px.gb[0], g_tex, v);
        store_warp_moments(warp_acc, k, cur.mask, v);
        cur = next;
        cur_tex = next_tex;
        k = k_next;
      }
    } else {  // the lane's pixels one after the other
      for (int k = pop_highest(cover); k >= 0; k = pop_highest(cover)) {
        const T* r = rows + k * W;
        const bool textured = r[W0 + kTexFlag] > (T)0.5;
        T v[kMoments];
#pragma unroll
        for (int i = 0; i < kMoments; ++i) v[i] = (T)0;
        bool any = false;
#pragma unroll
        for (int j = 0; j < P; ++j) {
          SlotInputs<T, C> s;
          load_slot(r, textured, px.in(j), px.x[j], px.y[j], px.zb[j], tex, tex_h, tex_w, s);
          if (!s.mask) continue;
          any = true;
          apply_slot<T, C, kErr>(s, textured, px.ob[j], px.x[j], px.y[j], tex_w, px.buf[j], px.gb[j], g_tex, v);
        }
        store_warp_moments(warp_acc, k, any, v);
      }
    }
  };
  // moment column of gradient column col: a plain slot owns t and the colour planes, a textured one t, u, v, shade
  auto column_of = [](const T* row, int col) {
    if (row[W0 + kTexFlag] > (T)0.5) return col < 3 ? col : (col >= GUV ? col - GUV + 3 : -1);
    return col < GUV ? col : -1;
  };
  edge_bwd_frame<T, C, kErr, P, W, GW>(table, counts, zbuf, obs, buf_final, g_out, n_tx, tile_h, tile_w, cap, pixels,
                                       g_rows, g_buf0, walk, column_of);
}

template <typename T>
struct TexArgs {
  const T *table, *zbuf, *obs, *tex;
  const int* counts;
  int n_tx, tile_h, tile_w, cap, tex_h, tex_w;
};

template <typename T, int C, bool kErr>
static cudaError_t tex_fwd_launch(int n_tiles, int threads, int blocks_per_tile, size_t smem_bytes, cudaStream_t s,
                                  const TexArgs<T>& a, const T* buf_in, T* buf_out) {
  if (!fwd_shape_ok(a.tile_h, a.tile_w, threads, blocks_per_tile, kTexFwdPixels, smem_bytes,
                    (35 + 3 * C) * sizeof(T)))
    return cudaErrorInvalidValue;
  edge_tex_fwd_kernel<T, C, kErr><<<n_tiles * blocks_per_tile, threads, smem_bytes, s>>>(
      a.table, a.counts, a.zbuf, a.obs, a.tex, buf_in, a.n_tx, a.tile_h, a.tile_w, a.cap, a.tex_h, a.tex_w,
      blocks_per_tile, buf_out);
  return cudaGetLastError();
}

template <typename T, int C, bool kErr>
static cudaError_t tex_bwd_launch(int n_tiles, int threads, int blocks_per_tile, int pixels, size_t smem_bytes,
                                  cudaStream_t s, const TexArgs<T>& a, const T* buf_final, const T* g_out, T* g_rows,
                                  T* g_buf0, T* g_tex) {
  if (pixels < 1 || pixels > kTexBwdPixels) return cudaErrorInvalidValue;
  if (smem_bytes != edge_bwd_smem_elems(35 + 3 * C, 12 + 3 * C, threads / 32) * sizeof(T))
    return cudaErrorInvalidValue;
  auto go = [&](auto kernel) {
    return launch_tile_clusters(kernel, n_tiles, threads, blocks_per_tile, smem_bytes, s, a.table, a.counts, a.zbuf,
                                a.obs, a.tex, buf_final, g_out, a.n_tx, a.tile_h, a.tile_w, a.cap, a.tex_h, a.tex_w,
                                pixels, g_rows, g_buf0, g_tex);
  };
  return pixels == 1 ? go(edge_tex_bwd_kernel<T, C, kErr, 1>) : go(edge_tex_bwd_kernel<T, C, kErr, kTexBwdPixels>);
}

// Calls f.template operator()<C, kErr>() for the run-time (c, err).
template <typename F>
static bool dispatch_c_err(int c, bool err, const F& f) {
  switch (c) {
    case 1: err ? f.template operator()<1, true>() : f.template operator()<1, false>(); return true;
    case 2: err ? f.template operator()<2, true>() : f.template operator()<2, false>(); return true;
    case 3: err ? f.template operator()<3, true>() : f.template operator()<3, false>(); return true;
    case 4: err ? f.template operator()<4, true>() : f.template operator()<4, false>(); return true;
    default: return false;
  }
}

template <typename T>
struct TexFwdCall {
  int n_tiles, threads, blocks_per_tile;
  size_t smem_bytes;
  cudaStream_t s;
  TexArgs<T> a;
  const T* buf_in;
  T* buf_out;
  mutable cudaError_t result;
  template <int C, bool kErr>
  void operator()() const {
    result = tex_fwd_launch<T, C, kErr>(n_tiles, threads, blocks_per_tile, smem_bytes, s, a, buf_in, buf_out);
  }
};

template <typename T>
struct TexBwdCall {
  int n_tiles, threads, blocks_per_tile, pixels;
  size_t smem_bytes;
  cudaStream_t s;
  TexArgs<T> a;
  const T *buf_final, *g_out;
  T *g_rows, *g_buf0, *g_tex;
  mutable cudaError_t result;
  template <int C, bool kErr>
  void operator()() const {
    result = tex_bwd_launch<T, C, kErr>(n_tiles, threads, blocks_per_tile, pixels, smem_bytes, s, a, buf_final,
                                        g_out, g_rows, g_buf0, g_tex);
  }
};

template <typename T>
static int edge_tex_fwd_launch(const void* table, const void* counts, const void* zbuf, const void* obs,
                               const void* tex, const void* buf_in, int n_tiles, int n_tx, int tile_h, int tile_w,
                               int cap, int c, int err, int tex_h, int tex_w, int threads, int blocks_per_tile,
                               int smem_bytes, void* buf_out, void* stream) {
  if (n_tiles == 0 || tile_h * tile_w == 0) return 0;
  if (tex_h < 2 || tex_w < 2) return (int)cudaErrorInvalidValue;
  TexFwdCall<T> call;
  call.n_tiles = n_tiles;
  call.threads = threads;
  call.blocks_per_tile = blocks_per_tile;
  call.smem_bytes = (size_t)smem_bytes;
  call.s = (cudaStream_t)stream;
  call.a = TexArgs<T>{(const T*)table, (const T*)zbuf, (const T*)obs, (const T*)tex, (const int*)counts,
                      n_tx, tile_h, tile_w, cap, tex_h, tex_w};
  call.buf_in = (const T*)buf_in;
  call.buf_out = (T*)buf_out;
  call.result = cudaErrorInvalidValue;
  if (!dispatch_c_err(c, err != 0, call)) return (int)cudaErrorInvalidValue;
  return (int)call.result;
}

template <typename T>
static int edge_tex_bwd_launch(const void* table, const void* counts, const void* zbuf, const void* obs,
                               const void* tex, const void* buf_final, const void* g_out, int n_tiles, int n_tx,
                               int tile_h, int tile_w, int cap, int c, int err, int tex_h, int tex_w, int threads,
                               int blocks_per_tile, int pixels, int smem_bytes, void* g_rows, void* g_buf0,
                               void* g_tex, void* stream) {
  if (n_tiles == 0) return 0;  // a tile without pixels still gets its zero rows
  if (tex_h < 2 || tex_w < 2) return (int)cudaErrorInvalidValue;
  TexBwdCall<T> call;
  call.n_tiles = n_tiles;
  call.threads = threads;
  call.blocks_per_tile = blocks_per_tile;
  call.pixels = pixels;
  call.smem_bytes = (size_t)smem_bytes;
  call.s = (cudaStream_t)stream;
  call.a = TexArgs<T>{(const T*)table, (const T*)zbuf, (const T*)obs, (const T*)tex, (const int*)counts,
                      n_tx, tile_h, tile_w, cap, tex_h, tex_w};
  call.buf_final = (const T*)buf_final;
  call.g_out = (const T*)g_out;
  call.g_rows = (T*)g_rows;
  call.g_buf0 = (T*)g_buf0;
  call.g_tex = (T*)g_tex;
  call.result = cudaErrorInvalidValue;
  if (!dispatch_c_err(c, err != 0, call)) return (int)cudaErrorInvalidValue;
  return (int)call.result;
}

}  // namespace deodr

extern "C" {

int edge_tex_fwd_f32(const void* table, const void* counts, const void* zbuf, const void* obs, const void* tex,
                     const void* buf_in, int n_tiles, int n_tx, int tile_h, int tile_w, int cap, int c, int err,
                     int tex_h, int tex_w, int threads, int blocks_per_tile, int smem_bytes, void* buf_out,
                     void* stream) {
  return deodr::edge_tex_fwd_launch<float>(table, counts, zbuf, obs, tex, buf_in, n_tiles, n_tx, tile_h, tile_w, cap, c,
                                           err, tex_h, tex_w, threads, blocks_per_tile, smem_bytes, buf_out, stream);
}

int edge_tex_fwd_f64(const void* table, const void* counts, const void* zbuf, const void* obs, const void* tex,
                     const void* buf_in, int n_tiles, int n_tx, int tile_h, int tile_w, int cap, int c, int err,
                     int tex_h, int tex_w, int threads, int blocks_per_tile, int smem_bytes, void* buf_out,
                     void* stream) {
  return deodr::edge_tex_fwd_launch<double>(table, counts, zbuf, obs, tex, buf_in, n_tiles, n_tx, tile_h, tile_w, cap,
                                            c, err, tex_h, tex_w, threads, blocks_per_tile, smem_bytes, buf_out, stream);
}

int edge_tex_bwd_f32(const void* table, const void* counts, const void* zbuf, const void* obs, const void* tex,
                     const void* buf_final, const void* g_out, int n_tiles, int n_tx, int tile_h, int tile_w, int cap,
                     int c, int err, int tex_h, int tex_w, int threads, int blocks_per_tile, int pixels,
                     int smem_bytes, void* g_rows, void* g_buf0, void* g_tex, void* stream) {
  return deodr::edge_tex_bwd_launch<float>(table, counts, zbuf, obs, tex, buf_final, g_out, n_tiles, n_tx, tile_h,
                                           tile_w, cap, c, err, tex_h, tex_w, threads, blocks_per_tile, pixels,
                                           smem_bytes, g_rows, g_buf0, g_tex, stream);
}

int edge_tex_bwd_f64(const void* table, const void* counts, const void* zbuf, const void* obs, const void* tex,
                     const void* buf_final, const void* g_out, int n_tiles, int n_tx, int tile_h, int tile_w, int cap,
                     int c, int err, int tex_h, int tex_w, int threads, int blocks_per_tile, int pixels,
                     int smem_bytes, void* g_rows, void* g_buf0, void* g_tex, void* stream) {
  return deodr::edge_tex_bwd_launch<double>(table, counts, zbuf, obs, tex, buf_final, g_out, n_tiles, n_tx, tile_h,
                                            tile_w, cap, c, err, tex_h, tex_w, threads, blocks_per_tile, pixels,
                                            smem_bytes, g_rows, g_buf0, g_tex, stream);
}

}  // extern "C"
