// Forward tile blend for Hopper (sm_90a), the port of the TPU kernel
// fourdgs_tpu/ops/pallas_blend.py::make_forward (body :330-433), reached
// through blend_pallas (:844-860).
//
// What it computes. Tile t owns the depth-sorted instances [start_t, stop_t)
// of the attribute-major payload feat[16, K] (rows: x, y, conic a/b/c,
// opacity, r, g, b, depth). Each of its 256 pixels blends them front to back:
//   power = -1/2 (a dx^2 + c dy^2) - b dx dy     (dx = px - x, integer px)
//   alpha = min(0.99, opacity exp(power)), kept iff power <= 0, alpha >= 1/255
//   w = alpha T,  T <- T (1 - alpha)
// and writes out[t, 5, 256] = (rgb + T_fin bg, depth, T_fin), channel-major.
//
// Semantics kept from the JAX kernel (not from the CUDA reference):
// - Windows: the tile's chunks start at off0 = min(floor(start/8)*8, K-8) and
//   step by CHUNK = 128 instances. Lanes outside [start, stop) are skipped.
// - T_STOP is per chunk: a pixel whose T would fall below 1e-4 skips only the
//   rest of that chunk and resumes at the next chunk with the T of its last
//   contributing instance (the JAX kernel's masked-min carry). No pixel is
//   done for good, and every tile walks all its chunks (the JAX tile-level
//   early exit can never fire, since the carried T never drops below T_STOP).
//   The chunk boundaries therefore change results on saturated pixels.
//
// Design. One block of 256 threads per tile, one thread per pixel. Per chunk
// the block stages the chunk's in-range instances (10 floats each, 5 KB) into
// shared memory with coalesced row loads; every thread then runs the serial
// per-pixel blend in float32, all threads reading the same instance at once
// (a shared-memory broadcast). Nothing carries across blocks. The TPU
// machinery (DMA ring, blocked payload, window roll, tiles per grid step,
// MXU scans, SMEM state) has no counterpart here.
//
// Bound. Per visited (pixel, instance) pair: ~15 float32 operations and one
// exp; the payload is read once per tile (40 B per walked instance) and the
// output written once (5 floats per pixel). At the shapes of an 800x800
// render the pairs dominate: the kernel is bound by operations.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;  // threads per block
constexpr int kChunk = 128;
constexpr int kAlign = 8;
constexpr int kRows = 10;            // payload rows read by the blend
constexpr float kAlphaCap = 0.99f;
constexpr float kAlphaFloor = (float)(1.0 / 255.0);
constexpr float kTStop = 1e-4f;

__global__ void __launch_bounds__(kPix)
blend_forward_kernel(const float* __restrict__ feat,   // [16, K]
                     const int* __restrict__ starts,   // [T]
                     const int* __restrict__ stops,    // [T]
                     const int* __restrict__ row_off,  // [2] = (offset, stride)
                     const float* __restrict__ bg,     // [3]
                     float* __restrict__ out,          // [T, 5, 256]
                     int k_pad, int grid_x) {
  __shared__ float s_feat[kRows][kChunk];

  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int start = starts[t];
  const int stop = stops[t];
  const int tx = t % grid_x;
  const int ty = (t / grid_x) * row_off[1] + row_off[0];
  const float px = (float)(tx * kTile + p % kTile);
  const float py = (float)(ty * kTile + p / kTile);

  int off0 = (start / kAlign) * kAlign;
  if (off0 > k_pad - kAlign) off0 = k_pad - kAlign;
  const int n_chunks = stop > start ? (stop - off0 + kChunk - 1) / kChunk : 0;

  float T = 1.0f;
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f, acc_d = 0.0f;

  for (int c = 0; c < n_chunks; ++c) {
    const int off = off0 + c * kChunk;
    const int j_lo = max(start - off, 0);
    const int j_hi = min(stop - off, kChunk);
    __syncthreads();  // the previous chunk's reads are done
    for (int i = p; i < kRows * kChunk; i += kPix) {
      const int r = i / kChunk;
      const int j = i % kChunk;
      if (j >= j_lo && j < j_hi) {
        s_feat[r][j] = feat[(size_t)r * k_pad + off + j];
      }
    }
    __syncthreads();

    for (int j = j_lo; j < j_hi; ++j) {
      const float dx = px - s_feat[0][j];
      const float dy = py - s_feat[1][j];
      const float power = -0.5f * (s_feat[2][j] * dx * dx +
                                   s_feat[4][j] * dy * dy) -
                          s_feat[3][j] * dx * dy;
      const float alpha = fminf(s_feat[5][j] * expf(power), kAlphaCap);
      if (!(power <= 0.0f) || !(alpha >= kAlphaFloor)) continue;
      const float t_next = T * (1.0f - alpha);
      if (!(t_next >= kTStop)) break;  // frozen until the chunk ends
      const float w = alpha * T;
      acc_r += w * s_feat[6][j];
      acc_g += w * s_feat[7][j];
      acc_b += w * s_feat[8][j];
      acc_d += w * s_feat[9][j];
      T = t_next;
    }
  }

  float* o = out + (size_t)t * 5 * kPix + p;
  o[0 * kPix] = acc_r + T * bg[0];
  o[1 * kPix] = acc_g + T * bg[1];
  o[2 * kPix] = acc_b + T * bg[2];
  o[3 * kPix] = acc_d;
  o[4 * kPix] = T;
}

}  // namespace

// Plain C interface, loaded with ctypes. Launches on `stream`, does not
// synchronise, allocates nothing; returns cudaGetLastError() of the launch.
extern "C" int fourdgs_blend_forward(const float* feat, const int* starts,
                                     const int* stops, const int* row_off,
                                     const float* bg, float* out,
                                     int num_tiles, int k_pad, int grid_x,
                                     void* stream) {
  if (num_tiles <= 0) return 0;
  blend_forward_kernel<<<num_tiles, kPix, 0, (cudaStream_t)stream>>>(
      feat, starts, stops, row_off, bg, out, k_pad, grid_x);
  return (int)cudaGetLastError();
}

extern "C" const char* fourdgs_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
