// Backward tile blend for Hopper (sm_90a), the port of the TPU kernel
// fourdgs_tpu/ops/pallas_blend.py::make_backward (body :495-784, call :808),
// reached through _blend_bwd (:873-895). It follows the kernel's default
// "vpu" reduction route (:694-711).
//
// What it computes. From the payload feat[16, K], K1's saved packed output
// out[T, 5, 256] = (rgb + T_fin bg, depth, T_fin) and its cotangent
// g_out[T, 5, 256], the gradient dfeat[16, K] of every instance. Each pixel
// re-walks its tile's instances front to back with K1's gates and T updates
// and, per contributing instance i (w_i = alpha_i T_i):
//   combo = r g_r + g g_g + b g_b + z g_d
//   pw   += w_i combo                    (inclusive prefix, carried over chunks)
//   S     = ctot - pw,  ctot = sum_q (out_q - T_fin bg_q) g_q + depth g_d
//   dα    = T_i combo - (S + T_fin g_T) / max(1 - α_i, 1e-6),
//           g_T = g_out[4] + sum_q bg_q g_q
//   dpow  = α_raw dα                     (α_raw = opacity exp(power), uncapped)
// and adds, over the tile's 256 pixels,
//   d(x, y)  = (a dx + b dy, c dy + b dx) dpow
//   d(a,b,c) = (-dx^2/2, -dx dy, -dy^2/2) dpow
//   d opacity = exp(power) dα            (uncapped, as the CUDA reference)
//   d(r,g,b,z) = w (g_r, g_g, g_b, g_d).
// Rows 10..15 and every slot outside all tile ranges (the sentinel tile past
// num_rendered) stay 0.
//
// The gates must be K1's bit for bit: the same blend_common.cuh arithmetic,
// the same T products in the same order, and the same per-chunk T_STOP rule
// (a pixel whose T would cross 1e-4 is frozen until the chunk ends and
// resumes at the next chunk).
//
// Design. One block of 256 threads per tile, one thread per pixel, the chunk's
// 10 payload rows staged in shared memory as in K1. Each thread walks the
// chunk serially. K1 `break`s out of the chunk; K2 cannot, since every lane
// takes part in the warp reductions, so a frozen pixel keeps walking and
// contributes zeros. Per instance the 10 per-pixel terms are summed over each
// warp by a shuffle butterfly (skipped, with zeros stored, when no lane of
// the warp contributes), the 8 per-warp partials go to shared memory
// (8 x 10 x 128 floats = 40 KB), and after the chunk the block adds them in a
// fixed order and stores the tile's own lanes [max(start-off,0),
// min(stop-off,128)) with plain stores. An instance belongs to exactly one
// tile, so no atomics are needed and the result is the same on every run. The
// JAX kernel's rolling dual-accumulator flush (:713-744) has no counterpart;
// a window's alignment lanes belong to the neighbouring tile and are never
// stored here. The wrapper zeroes dfeat first.
//
// Bound. Every (pixel, instance) pair in a tile's range takes the gates, 16
// float32 operations with the exp; a pair that blends takes 54 more (the T
// update, dα, the 10 terms and their sum over the tile). Bytes: the payload
// read once (40 B per instance), out and g_out read once (10 floats per
// pixel) and dfeat written once (64 B per slot). At the shapes of an 800x800
// train step, where about 18% of the pairs blend, writing dfeat over the 2M
// slots dominates: the bound is set by bytes.

#include <cuda_runtime.h>

#include "blend_common.cuh"

namespace {

using namespace fourdgs;

constexpr int kGrads = 10;             // gradient rows written
constexpr int kWarps = kPix / 32;      // 8

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kPix)
blend_backward_kernel(const float* __restrict__ feat,    // [16, K]
                      const int* __restrict__ starts,    // [T]
                      const int* __restrict__ stops,     // [T]
                      const int* __restrict__ row_off,   // [2]
                      const float* __restrict__ bg,      // [3]
                      const float* __restrict__ out,     // [T, 5, 256]
                      const float* __restrict__ g_out,   // [T, 5, 256]
                      float* __restrict__ dfeat,         // [16, K], zeroed
                      int k_pad, int grid_x) {
  __shared__ float s_feat[kRows][kChunk];
  __shared__ float s_part[kWarps][kGrads][kChunk];

  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  const Window win = tile_window(starts, stops, t, k_pad);
  float px, py;
  pixel_coords(t, p, grid_x, row_off, &px, &py);

  // per-pixel constants from the saved output and the cotangent
  const float* o = out + (size_t)t * 5 * kPix + p;
  const float* g = g_out + (size_t)t * 5 * kPix + p;
  const float g_r = g[0 * kPix], g_g = g[1 * kPix], g_b = g[2 * kPix];
  const float g_d = g[3 * kPix];
  const float t_fin = o[4 * kPix];
  const float bg_r = bg[0], bg_g = bg[1], bg_b = bg[2];
  const float gT_term =
      t_fin * (g[4 * kPix] + bg_r * g_r + bg_g * g_g + bg_b * g_b);
  const float ctot = (o[0 * kPix] - t_fin * bg_r) * g_r +
                     (o[1 * kPix] - t_fin * bg_g) * g_g +
                     (o[2 * kPix] - t_fin * bg_b) * g_b + o[3 * kPix] * g_d;

  float T = 1.0f;
  float pw = 0.0f;

  for (int c = 0; c < win.n_chunks; ++c) {
    const int off = win.off0 + c * kChunk;
    const int j_lo = max(win.start - off, 0);
    const int j_hi = min(win.stop - off, kChunk);
    __syncthreads();  // the previous chunk's reads of s_feat/s_part are done
    stage_chunk(s_feat, feat, k_pad, off, j_lo, j_hi, p);
    __syncthreads();

    bool frozen = false;  // T_STOP reached in this chunk
    for (int j = j_lo; j < j_hi; ++j) {  // block-uniform bounds: no divergence
      float v[kGrads];
#pragma unroll
      for (int q = 0; q < kGrads; ++q) v[q] = 0.0f;
      bool live = false;
      const Splat s = eval_splat(s_feat, j, px, py);
      if (s.keep && !frozen) {
        const float t_next = transmit(T, s.alpha);
        if (t_next >= kTStop) {
          live = true;
          const float w = s.alpha * T;
          const float combo = s_feat[6][j] * g_r + s_feat[7][j] * g_g +
                              s_feat[8][j] * g_b + s_feat[9][j] * g_d;
          pw += w * combo;
          const float S = ctot - pw;
          const float inv_om = 1.0f / fmaxf(1.0f - s.alpha, 1e-6f);
          const float dalpha = T * combo - inv_om * (S + gT_term);
          const float dpow = s.alpha_raw * dalpha;
          const float ca = s_feat[2][j], cb = s_feat[3][j], cc = s_feat[4][j];
          v[0] = (ca * s.dx + cb * s.dy) * dpow;
          v[1] = (cc * s.dy + cb * s.dx) * dpow;
          v[2] = -0.5f * s.dx * s.dx * dpow;
          v[3] = -s.dx * s.dy * dpow;
          v[4] = -0.5f * s.dy * s.dy * dpow;
          v[5] = s.exp_power * dalpha;
          v[6] = w * g_r;
          v[7] = w * g_g;
          v[8] = w * g_b;
          v[9] = w * g_d;
          T = t_next;
        } else {
          frozen = true;
        }
      }
      if (__any_sync(0xffffffffu, live)) {
#pragma unroll
        for (int q = 0; q < kGrads; ++q) v[q] = warp_sum(v[q]);
      }
      if (lane == 0) {
#pragma unroll
        for (int q = 0; q < kGrads; ++q) s_part[warp][q][j] = v[q];
      }
    }
    __syncthreads();

    // add the 8 warp partials in a fixed order; store the tile's own lanes
    for (int i = p; i < kGrads * kChunk; i += kPix) {
      const int q = i / kChunk;
      const int j = i % kChunk;
      if (j >= j_lo && j < j_hi) {
        float sum = s_part[0][q][j];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) sum += s_part[w][q][j];
        dfeat[(size_t)q * k_pad + off + j] = sum;
      }
    }
  }
}

}  // namespace

// Plain C interface, loaded with ctypes. Launches on `stream`, does not
// synchronise, allocates nothing; `dfeat` must be zeroed by the caller.
// Returns cudaGetLastError() of the launch.
extern "C" int fourdgs_blend_backward(const float* feat, const int* starts,
                                      const int* stops, const int* row_off,
                                      const float* bg, const float* out,
                                      const float* g_out, float* dfeat,
                                      int num_tiles, int k_pad, int grid_x,
                                      void* stream) {
  if (num_tiles <= 0) return 0;
  blend_backward_kernel<<<num_tiles, kPix, 0, (cudaStream_t)stream>>>(
      feat, starts, stops, row_off, bg, out, g_out, dfeat, k_pad, grid_x);
  return (int)cudaGetLastError();
}

extern "C" const char* fourdgs_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
