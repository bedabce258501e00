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
// Design. One block of 256 threads per tile, one thread per pixel, warp w on
// the strip of rows 2w, 2w+1. The chunk is staged as in K1, 16-byte records
// and the strip masks of blend_common.cuh's exact cull, and each warp walks
// only the instances whose mask meets its strip. K1 `break`s out of the
// chunk; K2 cannot, since every lane takes part in the warp reductions, so a
// frozen pixel keeps walking and contributes zeros. An instance with a live
// lane in the warp (__any_sync) goes into a batch of kBatch = 3 in
// registers, ten per-lane terms each (30 of 32 values, 2 zero); one with
// none is skipped. A full batch is summed over the warp by one
// reduce-scatter butterfly: 16+8+4+2+1 = 31 shuffles for three instances,
// where the warp sum of each term took 5 (50 per instance). Lane l then holds
// the warp sum of value l, the same bits as a butterfly of its own (both
// pair the lanes by bit 4 first, then 3, 2, 1, 0), and stores it to
// s_part[warp][q][j] in one step; a per-warp 128-bit mask records what was
// written, so stale and skipped entries add nothing. After the chunk the
// block adds the 8 warp partials in a fixed order and stores the tile's own
// lanes [max(start-off,0), min(stop-off,128)) with plain stores. An instance
// belongs to exactly one tile, so no atomics are needed and the result is the
// same on every run, with or without the cull. The JAX kernel's rolling
// dual-accumulator flush (:713-744) has no counterpart; a window's alignment
// lanes belong to the neighbouring tile and are never stored here. The
// wrapper zeroes dfeat first. The kernel asks for three resident blocks per
// SM (__launch_bounds__(256, 3)): the batch's 32 values and the walk fit in
// the registers that leaves, without spills (chip_smoke.py's phase 2 prints
// the ptxas line and the resident blocks); two blocks leave the SM too few
// warps to hide the shuffles' and shared loads' latency, four spill.
//
// Bound. A pair that passes the gates takes their 16 float32 operations, a
// pair that blends 54 more (the T update, dα, the 10 terms and their sum
// over the tile); the cull leaves unkept pairs nothing to compute. Bytes:
// the payload read once (40 B per instance), out and g_out read once (10
// floats per pixel) and dfeat written once (64 B per slot). At the shapes of
// an 800x800 train step writing dfeat over the 2M slots dominates: the bound
// is set by bytes.
//
// `cull` is a test hook: 1 (what ops/blend.py always passes) culls, 0 walks
// every in-range lane. Both give the same bits.

#include <cuda_runtime.h>

#include "blend_common.cuh"

namespace {

using namespace fourdgs;

constexpr int kGrads = 10;              // gradient rows written
constexpr int kBatch = 3;               // instances per warp reduction
constexpr int kVals = 32;               // kBatch * kGrads values, padded
constexpr int kPartStride = kChunk + 1; // s_part row: 10 lanes of one slot
                                        // fall in 10 banks
static_assert(kBatch * kGrads <= kVals, "a batch fits one value per lane");

// The per-pixel constants of the backward, from K1's output and g_out.
struct PixelGrad {
  float g_r, g_g, g_b, g_d;
  float ctot, gT_term;
};

// Instance j's ten per-pixel terms into v[10 kSlot ..], zeros unless the
// pixel blends it; updates T, pw and `frozen` as K1's walk would. Returns
// whether the pixel blends it.
template <int kSlot>
__device__ __forceinline__ bool pixel_terms(const Stage& s, int j, float px,
                                            float py, const PixelGrad& g,
                                            float& T, float& pw, bool& frozen,
                                            float (&v)[kVals]) {
  constexpr int b = kSlot * kGrads;
#pragma unroll
  for (int q = 0; q < kGrads; ++q) v[b + q] = 0.0f;
  const float4 geo = s.geo[j];
  const float4 opc = s.opc[j];
  const Splat sp = eval_splat(geo, opc, px, py);
  if (!sp.keep || frozen) return false;
  const float t_next = transmit(T, sp.alpha);
  if (!(t_next >= kTStop)) {
    frozen = true;
    return false;
  }
  const float w = sp.alpha * T;
  const float4 col = s.col[j];
  const float combo = col.x * g.g_r + col.y * g.g_g + col.z * g.g_b +
                      col.w * g.g_d;
  pw += w * combo;
  const float S = g.ctot - pw;
  const float inv_om = 1.0f / fmaxf(1.0f - sp.alpha, 1e-6f);
  const float dalpha = T * combo - inv_om * (S + g.gT_term);
  const float dpow = sp.alpha_raw * dalpha;
  const float ca = geo.z, cb = geo.w, cc = opc.x;
  v[b + 0] = (ca * sp.dx + cb * sp.dy) * dpow;
  v[b + 1] = (cc * sp.dy + cb * sp.dx) * dpow;
  v[b + 2] = -0.5f * sp.dx * sp.dx * dpow;
  v[b + 3] = -sp.dx * sp.dy * dpow;
  v[b + 4] = -0.5f * sp.dy * sp.dy * dpow;
  v[b + 5] = sp.exp_power * dalpha;
  v[b + 6] = w * g.g_r;
  v[b + 7] = w * g.g_g;
  v[b + 8] = w * g.g_b;
  v[b + 9] = w * g.g_d;
  T = t_next;
  return true;
}

// Slot kSlot of the batch: the next instance of the warp's list (from
// list[k], k advanced past it) that some lane blends, its terms in
// v[10 kSlot ..]; -1 (and zeros) when the list runs out.
template <int kSlot>
__device__ __forceinline__ int fill_slot(const Stage& s,
                                         const unsigned char* list, int n,
                                         int& k, float px, float py,
                                         const PixelGrad& g, float& T,
                                         float& pw, bool& frozen,
                                         float (&v)[kVals]) {
  while (k < n) {
    const int j = list[k++];
    const bool live = pixel_terms<kSlot>(s, j, px, py, g, T, pw, frozen, v);
    if (__any_sync(0xffffffffu, live)) return j;
  }
#pragma unroll
  for (int q = 0; q < kGrads; ++q) v[kSlot * kGrads + q] = 0.0f;
  return -1;
}

// One step of the reduce-scatter: of its 2*O values a lane keeps the half
// its bit O selects and adds the partner's copy of that half.
template <int O>
__device__ __forceinline__ void scatter_step(float (&v)[kVals], int lane) {
  const bool upper = lane & O;
#pragma unroll
  for (int i = 0; i < O; ++i) {
    const float send = upper ? v[i] : v[i + O];
    const float keep = upper ? v[i + O] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
  }
}

// reduce_scatter's shuffles, and those of a warp sum of a single value.
constexpr int kScatterShuffles = 16 + 8 + 4 + 2 + 1;
constexpr int kButterflyShuffles = 5;
static_assert(kScatterShuffles == kVals - 1, "one step per bit of the lane");

// After it, v[0] of lane l is the warp sum of value l.
__device__ __forceinline__ void reduce_scatter(float (&v)[kVals], int lane) {
  scatter_step<16>(v, lane);
  scatter_step<8>(v, lane);
  scatter_step<4>(v, lane);
  scatter_step<2>(v, lane);
  scatter_step<1>(v, lane);
}

__global__ void __launch_bounds__(kPix, 3)
blend_backward_kernel(const float* __restrict__ feat,    // [16, K]
                      const int* __restrict__ starts,    // [T]
                      const int* __restrict__ stops,     // [T]
                      const int* __restrict__ row_off,   // [2]
                      const float* __restrict__ bg,      // [3]
                      const float* __restrict__ out,     // [T, 5, 256]
                      const float* __restrict__ g_out,   // [T, 5, 256]
                      float* __restrict__ dfeat,         // [16, K], zeroed
                      int k_pad, int grid_x, int cull) {
  __shared__ Stage s;
  __shared__ float s_part[kWarps][kGrads][kPartStride];
  __shared__ unsigned s_written[kWarps][kChunk / 32];

  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  const Window win = tile_window(starts, stops, t, k_pad);
  float x0, y0;
  tile_origin(t, grid_x, row_off, &x0, &y0);
  const float px = x0 + (float)(p % kTile);
  const float py = y0 + (float)(p / kTile);

  // per-pixel constants from the saved output and the cotangent
  const float* o = out + (size_t)t * 5 * kPix + p;
  const float* gp = g_out + (size_t)t * 5 * kPix + p;
  PixelGrad g;
  g.g_r = gp[0 * kPix];
  g.g_g = gp[1 * kPix];
  g.g_b = gp[2 * kPix];
  g.g_d = gp[3 * kPix];
  const float t_fin = o[4 * kPix];
  const float bg_r = bg[0], bg_g = bg[1], bg_b = bg[2];
  g.gT_term = t_fin * (gp[4 * kPix] + bg_r * g.g_r + bg_g * g.g_g +
                       bg_b * g.g_b);
  g.ctot = (o[0 * kPix] - t_fin * bg_r) * g.g_r +
           (o[1 * kPix] - t_fin * bg_g) * g.g_g +
           (o[2 * kPix] - t_fin * bg_b) * g.g_b + o[3 * kPix] * g.g_d;

  // lane l < 10 * kBatch stores value l: term q of the batch's slot l / 10
  const int my_slot = lane / kGrads;
  const int my_q = lane - kGrads * my_slot;

  float T = 1.0f;
  float pw = 0.0f;

  for (int c = 0; c < win.n_chunks; ++c) {
    const int off = win.off0 + c * kChunk;
    const int j_lo = max(win.start - off, 0);
    const int j_hi = min(win.stop - off, kChunk);
    __syncthreads();  // the previous chunk's reads of s, s_part are done
    stage_chunk(s, feat, k_pad, off, j_lo, j_hi, p, x0, y0, cull);
    __syncthreads();

    const int n = warp_list(s, warp, lane);
    const unsigned char* list = s.list[warp];
    int k = 0;
    bool frozen = false;  // T_STOP reached in this chunk
    unsigned written = 0u;  // lane l < 4: lanes 32l..32l+31 stored by this warp
    while (k < n) {
      float v[kVals];
      v[30] = v[31] = 0.0f;
      const int j0 = fill_slot<0>(s, list, n, k, px, py, g, T, pw, frozen, v);
      if (j0 < 0) break;
      const int j1 = fill_slot<1>(s, list, n, k, px, py, g, T, pw, frozen, v);
      const int j2 = fill_slot<2>(s, list, n, k, px, py, g, T, pw, frozen, v);
      reduce_scatter(v, lane);
      const int j = my_slot == 0 ? j0 : my_slot == 1 ? j1 : my_slot == 2 ? j2 : -1;
      if (j >= 0) s_part[warp][my_q][j] = v[0];
      if (lane == (j0 >> 5)) written |= 1u << (j0 & 31);
      if (j1 >= 0 && lane == (j1 >> 5)) written |= 1u << (j1 & 31);
      if (j2 >= 0 && lane == (j2 >> 5)) written |= 1u << (j2 & 31);
    }
    if (lane < kChunk / 32) s_written[warp][lane] = written;
    __syncthreads();

    // add the written warp partials in a fixed order; store the tile's own
    // lanes. Thread p owns lane p % 128, rows p / 128, +2, +4, ...
    const int j = p & (kChunk - 1);
    if (j >= j_lo && j < j_hi) {
      unsigned from = 0u;  // bit w: warp w stored lane j
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        from |= ((s_written[w][j >> 5] >> (j & 31)) & 1u) << w;
      for (int q = p / kChunk; q < kGrads; q += kPix / kChunk) {
        float sum = 0.0f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w)
          if (from & (1u << w)) sum += s_part[w][q][j];
        dfeat[(size_t)q * k_pad + off + j] = sum;
      }
    }
  }
}

}  // namespace

// Plain C interface, loaded with ctypes. Launches on `stream`, does not
// synchronise, allocates nothing; `dfeat` must be zeroed by the caller.
// `cull`: 1 culls, 0 walks every in-range lane (the test hook above).
// Returns cudaGetLastError() of the launch.
extern "C" int fourdgs_blend_backward(const float* feat, const int* starts,
                                      const int* stops, const int* row_off,
                                      const float* bg, const float* out,
                                      const float* g_out, float* dfeat,
                                      int num_tiles, int k_pad, int grid_x,
                                      int cull, void* stream) {
  if (num_tiles <= 0) return 0;
  blend_backward_kernel<<<num_tiles, kPix, 0, (cudaStream_t)stream>>>(
      feat, starts, stops, row_off, bg, out, g_out, dfeat, k_pad, grid_x,
      cull);
  return (int)cudaGetLastError();
}

// How many blocks of the kernel one SM holds at once, into *n.
extern "C" int fourdgs_blend_backward_blocks_per_sm(int* n) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      n, blend_backward_kernel, kPix, 0);
}

// The warp reduction's shape, for the work counts: instances per
// reduce-scatter, its shuffles, and the shuffles per instance of ten
// separate warp sums (the reduction before batching).
extern "C" int fourdgs_blend_backward_reduction(int* batch, int* shuffles,
                                                int* unbatched) {
  *batch = kBatch;
  *shuffles = kScatterShuffles;
  *unbatched = kGrads * kButterflyShuffles;
  return 0;
}

extern "C" const char* fourdgs_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
