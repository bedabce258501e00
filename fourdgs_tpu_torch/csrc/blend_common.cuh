// Shared by blend_forward.cu (K1) and blend_backward.cu (K2): the layout
// constants, the tile windows, the staging of a chunk with its per-warp cull,
// and the per-(pixel, instance) gates of the tile blend.
//
// K2 re-walks K1's blend and must take the same decisions bit for bit: which
// instances a pixel keeps, and where its transmittance would cross T_STOP.
// Otherwise a pixel riding T_STOP gets gradients for instances K1 never
// blended. So the gate arithmetic lives here once, and every operation in it
// is an explicitly rounded intrinsic (__fmul_rn, __fadd_rn, __fsub_rn), which
// nvcc never contracts into an FMA, whatever code surrounds the call. The
// association follows the plain PyTorch version: ((a dx) dx), ((c dy) dy),
// ((b dx) dy).
//
// The cull. Warp w of a block owns pixel rows 2w and 2w+1 of the tile, a
// 16x2 strip. With Q = [[a, b], [b, c]] and power = -1/2 d'Qd, a kept pair
// (power <= 0 and opacity exp(power) >= 1/255) has d'Qd <= 2L, L =
// ln(255 opacity). While a chunk is staged, strip_mask() bounds that ellipse
// by its pixel box and sets bit w when the box meets strip w; each warp then
// walks only the in-range instances whose mask has its bit (warp_list), in j
// order. A culled pair can never be kept and an unkept pair changes nothing
// in either kernel, so the walk keeps every output bit. `cull = 0` gives
// every in-range instance a full mask: the walk of every in-range lane, the
// test hook that proves the cull exact (ops/blend.py, `_cull`).

#pragma once

#include <cuda_runtime.h>

namespace fourdgs {

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;  // threads per block: one per pixel
constexpr int kChunk = 128;          // instances per window chunk
constexpr int kAlign = 8;            // window start alignment
constexpr int kWarps = kPix / 32;    // 8 warps, warp w owns rows 2w, 2w+1
constexpr unsigned kAllStrips = (1u << kWarps) - 1u;
constexpr float kAlphaCap = 0.99f;
constexpr float kAlphaFloor = (float)(1.0 / 255.0);
constexpr float kTStop = 1e-4f;
static_assert(kPix == 2 * kChunk, "staging gives each thread half an instance");

// The cull's margin (strip_mask), a relative term and a pixel. The float32
// gate rounds each of qa, qc, qb four times (dx or dy twice, two products)
// and power twice more, so |power_f - power| <= 3u M with u = 2^-24 and
// M = a dx^2 + c dy^2 + 2|b dx dy| <= (a + |b|) dx^2 + (c + |b|) dy^2: an
// error relative to the terms' sizes, not to power, which near-singular
// conics make large. A kept pair then has d'Qd <= 2L + 6u M, that is
// d'Q'd <= 2L with Q' = Q - kGamma diag(a + |b|, c + |b|), kGamma = 1e-6
// > 6u: the box is that of Q'. L grows by kLogSlack for 2^-20-relative
// errors of expf, of opacity * exp and of the float 1/255. One pixel on each
// side (kPadPx) covers what the analysis leaves out: the box's own double
// rounding, and an expf or a host exp that strays past its documented ulp
// bound.
constexpr double kGamma = 1e-6;
constexpr double kLogSlack = 1e-5;
constexpr double kPadPx = 1.0;

// Tile t's window: chunks start at off0 = min(floor(start/8)*8, K-8) and step
// by kChunk; n_chunks = 0 for an empty tile.
struct Window {
  int start, stop, off0, n_chunks;
};

__device__ __forceinline__ Window tile_window(const int* starts,
                                              const int* stops, int t,
                                              int k_pad) {
  Window w;
  w.start = starts[t];
  w.stop = stops[t];
  w.off0 = (w.start / kAlign) * kAlign;
  if (w.off0 > k_pad - kAlign) w.off0 = k_pad - kAlign;
  w.n_chunks = w.stop > w.start ? (w.stop - w.off0 + kChunk - 1) / kChunk : 0;
  return w;
}

// The pixel coordinates of tile t's first pixel, tile rows mapped to
// offset + j * stride.
__device__ __forceinline__ void tile_origin(int t, int grid_x,
                                            const int* row_off, float* x0,
                                            float* y0) {
  const int tx = t % grid_x;
  const int ty = (t / grid_x) * row_off[1] + row_off[0];
  *x0 = (float)(tx * kTile);
  *y0 = (float)(ty * kTile);
}

// One staged chunk: each instance as 16-byte records, so a pixel reads the
// gate's six values in two 128-bit broadcasts and the colour in one.
struct Stage {
  float4 geo[kChunk];      // x, y, conic a, conic b
  float4 opc[kChunk];      // conic c, opacity, 0, 0
  float4 col[kChunk];      // r, g, b, depth
  unsigned mask[kChunk];   // strips the instance may touch; 0 out of range
  unsigned char list[kWarps][kChunk];  // each warp's lanes to walk, j order
};

// Bit w set when strip w (rows y0 + 2w, y0 + 2w + 1, columns x0..x0+15)
// meets the instance's padded ellipse box; see kGamma above. In double:
// the box's own rounding is then far below the pixel of padding.
__device__ __forceinline__ unsigned strip_mask(float x, float y, float a,
                                               float b, float c, float o,
                                               float x0, float y0) {
  // alpha <= opacity * expf(power) and expf(power <= 0) <= 1 (2^-20 slack)
  if ((double)o < (double)kAlphaFloor * (1.0 - 0x1p-18)) return 0u;
  if (!(isfinite(x) && isfinite(y) && isfinite(a) && isfinite(b) &&
        isfinite(c) && isfinite(o)))
    return kAllStrips;
  const double bb = fabs((double)b);
  const double a2 = a - kGamma * (a + bb);
  const double c2 = c - kGamma * (c + bb);
  const double det = a2 * c2 - (double)b * b;
  if (!(a2 > 0.0) || !(det > 0.0)) return kAllStrips;  // not positive definite
  const double k = 2.0 * (fmax(log(255.0 * o), 0.0) + kLogSlack);
  const double hx = sqrt(k * c2 / det) + kPadPx;
  const double hy = sqrt(k * a2 / det) + kPadPx;
  if (x + hx < x0 || x - hx > x0 + (kTile - 1)) return 0u;
  const double r_lo = fmax(ceil(y - hy - y0), 0.0);
  const double r_hi = fmin(floor(y + hy - y0), kTile - 1.0);
  if (r_lo > r_hi) return 0u;
  const int w_lo = (int)r_lo >> 1, w_hi = (int)r_hi >> 1;
  return (2u << w_hi) - (1u << w_lo);
}

// Stage the in-range lanes [j_lo, j_hi) of the chunk at `off`, rows 0..9 of
// the attribute-major payload: threads 0..127 take lane p's six gate values
// and its mask, threads 128..255 its colour. The loads stay coalesced along
// K; the transpose into records happens in shared memory. All kPix threads
// call it.
__device__ __forceinline__ void stage_chunk(Stage& s,
                                            const float* __restrict__ feat,
                                            int k_pad, int off, int j_lo,
                                            int j_hi, int p, float x0,
                                            float y0, int cull) {
  const int j = p & (kChunk - 1);
  const bool in = j >= j_lo && j < j_hi;
  const float* f = feat + off + j;
  if (p < kChunk) {
    unsigned m = 0u;
    if (in) {
      const float x = f[0], y = f[k_pad];
      const float a = f[2 * (size_t)k_pad], b = f[3 * (size_t)k_pad];
      const float c = f[4 * (size_t)k_pad], o = f[5 * (size_t)k_pad];
      s.geo[j] = make_float4(x, y, a, b);
      s.opc[j] = make_float4(c, o, 0.0f, 0.0f);
      m = cull ? strip_mask(x, y, a, b, c, o, x0, y0) : kAllStrips;
    }
    s.mask[j] = m;
  } else if (in) {
    s.col[j] = make_float4(f[6 * (size_t)k_pad], f[7 * (size_t)k_pad],
                           f[8 * (size_t)k_pad], f[9 * (size_t)k_pad]);
  }
}

// Compact the lanes of the staged chunk whose mask has warp `warp`'s bit
// into s.list[warp], in j order (__ballot_sync + __popc); returns their
// count, the same in every lane. The walk then reads its next lane with one
// broadcast load at a counted index, which the compiler can issue ahead.
__device__ __forceinline__ int warp_list(Stage& s, int warp, int lane) {
  const unsigned below = (1u << lane) - 1u;
  int n = 0;
#pragma unroll
  for (int i = 0; i < kChunk / 32; ++i) {
    const int j = 32 * i + lane;
    const bool mine = (s.mask[j] >> warp) & 1u;
    const unsigned ballot = __ballot_sync(0xffffffffu, mine);
    if (mine) s.list[warp][n + __popc(ballot & below)] = (unsigned char)j;
    n += __popc(ballot);
  }
  __syncwarp();
  return n;
}

struct Splat {
  float dx, dy;       // pixel minus mean
  float exp_power;    // exp(power)
  float alpha_raw;    // opacity * exp(power), uncapped
  float alpha;        // min(alpha_raw, 0.99)
  bool keep;          // power <= 0 and alpha >= 1/255
};

// power = -1/2 (a dx^2 + c dy^2) - b dx dy and the gates, for the staged
// records geo = (x, y, a, b), opc = (c, opacity) at pixel (px, py).
__device__ __forceinline__ Splat eval_splat(float4 geo, float4 opc, float px,
                                            float py) {
  Splat s;
  s.dx = __fsub_rn(px, geo.x);
  s.dy = __fsub_rn(py, geo.y);
  const float qa = __fmul_rn(__fmul_rn(geo.z, s.dx), s.dx);
  const float qc = __fmul_rn(__fmul_rn(opc.x, s.dy), s.dy);
  const float qb = __fmul_rn(__fmul_rn(geo.w, s.dx), s.dy);
  const float power = __fsub_rn(__fmul_rn(-0.5f, __fadd_rn(qa, qc)), qb);
  s.exp_power = expf(power);
  s.alpha_raw = __fmul_rn(opc.y, s.exp_power);
  s.alpha = fminf(s.alpha_raw, kAlphaCap);
  s.keep = (power <= 0.0f) && (s.alpha >= kAlphaFloor);
  return s;
}

// The transmittance after a kept instance: T (1 - alpha).
__device__ __forceinline__ float transmit(float T, float alpha) {
  return __fmul_rn(T, __fsub_rn(1.0f, alpha));
}

}  // namespace fourdgs
