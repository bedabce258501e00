// Shared by blend_forward.cu (K1) and blend_backward.cu (K2): the layout
// constants, the tile windows and the per-(pixel, instance) gates of the
// tile blend.
//
// K2 re-walks K1's blend and must take the same decisions bit for bit: which
// instances a pixel keeps, and where its transmittance would cross T_STOP.
// Otherwise a pixel riding T_STOP gets gradients for instances K1 never
// blended. So the gate arithmetic lives here once, and every operation in it
// is an explicitly rounded intrinsic (__fmul_rn, __fadd_rn, __fsub_rn), which
// nvcc never contracts into an FMA, whatever code surrounds the call. The
// association follows the plain PyTorch version: ((a dx) dx), ((c dy) dy),
// ((b dx) dy).

#pragma once

namespace fourdgs {

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;  // threads per block: one per pixel
constexpr int kChunk = 128;          // instances per window chunk
constexpr int kAlign = 8;            // window start alignment
constexpr int kRows = 10;            // payload rows read by the blend
constexpr float kAlphaCap = 0.99f;
constexpr float kAlphaFloor = (float)(1.0 / 255.0);
constexpr float kTStop = 1e-4f;

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

// Pixel p of tile t, tile rows mapped to offset + j * stride.
__device__ __forceinline__ void pixel_coords(int t, int p, int grid_x,
                                             const int* row_off, float* px,
                                             float* py) {
  const int tx = t % grid_x;
  const int ty = (t / grid_x) * row_off[1] + row_off[0];
  *px = (float)(tx * kTile + p % kTile);
  *py = (float)(ty * kTile + p / kTile);
}

// Stage the in-range lanes [j_lo, j_hi) of the chunk at `off` into shared
// memory, rows 0..9 of the attribute-major payload. All kPix threads call it.
__device__ __forceinline__ void stage_chunk(float (*s_feat)[kChunk],
                                            const float* __restrict__ feat,
                                            int k_pad, int off, int j_lo,
                                            int j_hi, int p) {
  for (int i = p; i < kRows * kChunk; i += kPix) {
    const int r = i / kChunk;
    const int j = i % kChunk;
    if (j >= j_lo && j < j_hi) {
      s_feat[r][j] = feat[(size_t)r * k_pad + off + j];
    }
  }
}

struct Splat {
  float dx, dy;       // pixel minus mean
  float exp_power;    // exp(power)
  float alpha_raw;    // opacity * exp(power), uncapped
  float alpha;        // min(alpha_raw, 0.99)
  bool keep;          // power <= 0 and alpha >= 1/255
};

// power = -1/2 (a dx^2 + c dy^2) - b dx dy and the gates, for instance j of
// the staged chunk at pixel (px, py).
__device__ __forceinline__ Splat eval_splat(const float (*s_feat)[kChunk],
                                            int j, float px, float py) {
  Splat s;
  s.dx = __fsub_rn(px, s_feat[0][j]);
  s.dy = __fsub_rn(py, s_feat[1][j]);
  const float qa = __fmul_rn(__fmul_rn(s_feat[2][j], s.dx), s.dx);
  const float qc = __fmul_rn(__fmul_rn(s_feat[4][j], s.dy), s.dy);
  const float qb = __fmul_rn(__fmul_rn(s_feat[3][j], s.dx), s.dy);
  const float power = __fsub_rn(__fmul_rn(-0.5f, __fadd_rn(qa, qc)), qb);
  s.exp_power = expf(power);
  s.alpha_raw = __fmul_rn(s_feat[5][j], s.exp_power);
  s.alpha = fminf(s.alpha_raw, kAlphaCap);
  s.keep = (power <= 0.0f) && (s.alpha >= kAlphaFloor);
  return s;
}

// The transmittance after a kept instance: T (1 - alpha).
__device__ __forceinline__ float transmit(float T, float alpha) {
  return __fmul_rn(T, __fsub_rn(1.0f, alpha));
}

}  // namespace fourdgs
