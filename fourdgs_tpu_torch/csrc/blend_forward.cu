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
// Design. One block of 256 threads per tile, one thread per pixel, warp w
// on the strip of pixel rows 2w, 2w+1. Per chunk the block stages the
// chunk's in-range instances from coalesced row loads into 16-byte records
// in shared memory and computes each instance's strip mask, the exact cull
// of blend_common.cuh. Each warp then walks only the instances whose mask
// meets its strip, in order; a thread reads the gate's six values in two
// 128-bit shared-memory broadcasts and, when the pair is kept, the colour in
// one (ten scalar loads per pair before), and `break`s out of the chunk at
// T_STOP on its own. Nothing carries across blocks. The TPU machinery (DMA
// ring, blocked payload, window roll, tiles per grid step, MXU scans, SMEM
// state) has no counterpart here. The gates (power, alpha, keep, the T
// update) come from blend_common.cuh, which the backward kernel shares, so
// the two take the same decisions bit for bit.
//
// Bound. A pair that passes the gates takes 16 float32 operations for them,
// the exp counted as one, and 12 more if it blends (the T update, w and four
// colour multiply-adds); the cull leaves unkept pairs nothing to compute.
// The payload is read once (40 B per instance) and the output written once
// (5 floats per pixel). With kept pairs counted, an 800x800 view is bound by
// those bytes; counting every in-range pair's gate, as before the cull, by
// operations.
//
// `cull` is a test hook: 1 (what ops/blend.py always passes) culls, 0 walks
// every in-range lane as the kernel did before the cull. Both give the same
// bits.

#include <cuda_runtime.h>

#include "blend_common.cuh"

namespace {

using namespace fourdgs;

__global__ void __launch_bounds__(kPix)
blend_forward_kernel(const float* __restrict__ feat,   // [16, K]
                     const int* __restrict__ starts,   // [T]
                     const int* __restrict__ stops,    // [T]
                     const int* __restrict__ row_off,  // [2] = (offset, stride)
                     const float* __restrict__ bg,     // [3]
                     float* __restrict__ out,          // [T, 5, 256]
                     int k_pad, int grid_x, int cull) {
  __shared__ Stage s;

  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int warp = p >> 5;
  const Window win = tile_window(starts, stops, t, k_pad);
  float x0, y0;
  tile_origin(t, grid_x, row_off, &x0, &y0);
  const float px = x0 + (float)(p % kTile);
  const float py = y0 + (float)(p / kTile);

  float T = 1.0f;
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f, acc_d = 0.0f;

  for (int c = 0; c < win.n_chunks; ++c) {
    const int off = win.off0 + c * kChunk;
    const int j_lo = max(win.start - off, 0);
    const int j_hi = min(win.stop - off, kChunk);
    __syncthreads();  // the previous chunk's reads are done
    stage_chunk(s, feat, k_pad, off, j_lo, j_hi, p, x0, y0, cull);
    __syncthreads();

    const int n = warp_list(s, warp, p & 31);
    for (int k = 0; k < n; ++k) {
      const int j = s.list[warp][k];
      const Splat sp = eval_splat(s.geo[j], s.opc[j], px, py);
      if (!sp.keep) continue;
      const float t_next = transmit(T, sp.alpha);
      if (!(t_next >= kTStop)) break;  // frozen until the chunk ends
      const float w = sp.alpha * T;
      const float4 col = s.col[j];
      acc_r += w * col.x;
      acc_g += w * col.y;
      acc_b += w * col.z;
      acc_d += w * col.w;
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

// The strip masks of the cull as the blend stages them, for its checks and
// counts (ops/blend.py::strip_masks), not for the blend: each chunk of tile
// t goes through K1's stage_chunk, and each in-range lane's mask is stored
// to masks[off + j]. An instance lies in one tile's range, so a slot is
// written at most once; the caller zeroes the others.
__global__ void __launch_bounds__(kPix)
strip_masks_kernel(const float* __restrict__ feat,   // [16, K]
                   const int* __restrict__ starts,   // [T]
                   const int* __restrict__ stops,    // [T]
                   const int* __restrict__ row_off,  // [2]
                   int* __restrict__ masks,          // [K], zeroed
                   int k_pad, int grid_x) {
  __shared__ Stage s;

  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const Window win = tile_window(starts, stops, t, k_pad);
  float x0, y0;
  tile_origin(t, grid_x, row_off, &x0, &y0);
  for (int c = 0; c < win.n_chunks; ++c) {
    const int off = win.off0 + c * kChunk;
    const int j_lo = max(win.start - off, 0);
    const int j_hi = min(win.stop - off, kChunk);
    __syncthreads();
    stage_chunk(s, feat, k_pad, off, j_lo, j_hi, p, x0, y0, 1);
    __syncthreads();
    if (p >= j_lo && p < j_hi) masks[off + p] = (int)s.mask[p];
  }
}

}  // namespace

// Plain C interface, loaded with ctypes. Launches on `stream`, does not
// synchronise, allocates nothing; returns cudaGetLastError() of the launch.
// `cull`: 1 culls, 0 walks every in-range lane (the test hook above).
extern "C" int fourdgs_blend_forward(const float* feat, const int* starts,
                                     const int* stops, const int* row_off,
                                     const float* bg, float* out,
                                     int num_tiles, int k_pad, int grid_x,
                                     int cull, void* stream) {
  if (num_tiles <= 0) return 0;
  blend_forward_kernel<<<num_tiles, kPix, 0, (cudaStream_t)stream>>>(
      feat, starts, stops, row_off, bg, out, k_pad, grid_x, cull);
  return (int)cudaGetLastError();
}

// strip_masks_kernel over the tiles, as fourdgs_blend_forward launches K1.
extern "C" int fourdgs_blend_forward_strip_masks(const float* feat,
                                                 const int* starts,
                                                 const int* stops,
                                                 const int* row_off,
                                                 int* masks, int num_tiles,
                                                 int k_pad, int grid_x,
                                                 void* stream) {
  if (num_tiles <= 0) return 0;
  strip_masks_kernel<<<num_tiles, kPix, 0, (cudaStream_t)stream>>>(
      feat, starts, stops, row_off, masks, k_pad, grid_x);
  return (int)cudaGetLastError();
}

// How many blocks of the kernel one SM holds at once, into *n.
extern "C" int fourdgs_blend_forward_blocks_per_sm(int* n) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      n, blend_forward_kernel, kPix, 0);
}

extern "C" const char* fourdgs_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
