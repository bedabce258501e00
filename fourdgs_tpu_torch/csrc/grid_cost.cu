// Grid-cost probes for Hopper (sm_90a), the port of the TPU kernels of
// scripts/exp_grid_cost.py (:44-152). Each TPU kernel writes constant blocks
// over a grid of T = 2500 steps, one 16x16 tile of N = 256 pixels per step,
// to time the blend kernels' per-grid-step cost. On Hopper each becomes a
// launch of one small kernel whose time is launch latency plus a per-block
// cost: the experiment's point, since the blend kernels K1 and K2 launch one
// block per tile.
//
// The TPU grid and its Hopper mapping, per probe (out [T, 256, c] float32,
// row-major, c channels per pixel):
//   K4  k1 (:49-50, call :53), ones [T,256,1], both mappings storing a
//       tile's 1 KB as float4, a warp per tile (K10's mapping without its
//       load and loop). "parallel": 8 tiles per block of 256 threads, each
//       lane storing two float4 of its tile, ceil(T/8) blocks (313 at
//       T = 2500; surplus warps of the last block return). "arbitrary" (the
//       sequential grid of one TPU core): a persistent grid of one block of
//       256 threads per SM (the caller passes the block count), each warp
//       striding over the tiles t = blockIdx.x * 8 + warp + i * gridDim.x * 8.
//       Measured against them and removed (exp_grid_cost.run(), an H100
//       80GB HBM3 at 700 W), all within 0.01 us of the kept ones:
//       4 tiles per block of 128 threads, 4 tiles per block with two warps
//       per tile storing one float4 a lane, and the persistent grid at 2
//       blocks per SM. The first port's mappings, a block per tile storing
//       one float a thread (2500 blocks) and the persistent block storing
//       1 KB a trip, lost 1.38x and 1.03x to torch.ones.
//   K5  k3 (:62-65, call :67), ones into three outputs [T,256,3], [T,256,1],
//       [T,256,1]: one block per tile, thread n writes its pixel of all three.
//   K6  k1 into a (1,256,5) block (call :78). The JAX kernel is ill-formed: it
//       stores a (256,1) value into a (256,5) block, which its trace rejects
//       when it is traced (the script rebinds f5 at :88 before calling it).
//       Ported as its intended function, the (256,1) value broadcast across
//       the 5 channels. Its output is K7's. One block per tile: thread n
//       computes pixel n's value once, in a register, and each warp writes
//       its 32 pixels' 160 contiguous floats (a multiple of 640 B into a
//       tile that starts at a multiple of 5120 B) as 40 float4 stores, the
//       values of float4 j gathered by shuffles from lanes 4j/5 .. (4j+3)/5.
//       Measured on an H100 80GB HBM3 at 700 W against it: the tile staged in shared memory
//       behind a barrier (4 tiles per block 1.04-1.07x torch.ones), 2 or 4
//       tiles per block (about 1% slower), and Hopper's bulk asynchronous
//       store of the staged tile (cp.async.bulk, 1.06x). PR 3's mapping,
//       thread n storing its value at 5n .. 5n+4, spread each warp store
//       over 20 sectors and took four times K7's time.
//   K7  k5 (:85-86, call :88), ones [T,256,5]: a warp per tile (the TPU's
//       (1,256,5) block, 1280 contiguous floats starting at byte 5120 t, so
//       16-byte aligned), each lane storing 10 float4 at lane + 32 i, a warp
//       store covering 512 contiguous bytes; 4 tiles per block of 128
//       threads, ceil(T/4) blocks (625 at T = 2500).
//   K8  kp (:97-98, call :100), ones [T,256,5], two tiles per grid step: a
//       warp per pair (the TPU's (2,256,5) block, 2560 contiguous floats),
//       20 float4 a lane; 2 pairs per block of 64 threads, ceil(T/4) blocks
//       (T even).
//       K7 and K8 are bound by their 12.8 MB written once (3.8 us at
//       3.35 TB/s), under the launch's own latency, and what sets their time
//       past it is how evenly the bytes spread over the 132 SMs: a block of
//       4 tiles (20 KB) leaves at most 5 blocks (100 KB) on an SM where the
//       mean is 97 KB. Measured in turns on an H100 80GB HBM3 at 700 W
//       (exp_grid_cost's timer, T = 2500, ms, three runs of 4-8 readings
//       each; torch.ones 0.00519-0.00527): kept K7 0.00510-0.00530 (medians
//       0.00513-0.00525), K8 0.00508-0.00529 (0.00514-0.00522). Against
//       them, K7 / K8: 8 tiles (pairs) per block of 256 threads, 313 / 157
//       blocks, 0.00536-0.00548 / 0.00605-0.00626 (an SM holds 120 or
//       160 KB), with streaming stores (__stcs) no faster; 4 pairs per block
//       of 128 threads (313 blocks) 0.00534-0.00552; a tile (pair) per block
//       of 32 threads 0.00516-0.00543 / 0.00508-0.00523, 2 tiles per block
//       of 64 threads 0.00508-0.00525, a tile (pair) per block split over 2
//       or 4 warps 0.00516-0.00544 / 0.00505-0.00529; a persistent block per
//       SM, units dealt to the blocks in turn, 0.00514-0.00525 /
//       0.00508-0.00527 (K7 with K4 "arbitrary"'s striding, 0.00555-0.00565);
//       K7 as a tile of ones staged in shared memory and stored by
//       cp.async.bulk, 0.00545-0.00553. The first port's mapping, a block of
//       256 threads per tile (pair) storing a float each, read
//       0.00525-0.00532 / 0.00520-0.00527.
//   K9  kw (:111-117, call :119), out[t,n,0] = n % 16 + tri[0,0], where tri
//       is the 128x128 strict upper triangle i < j: K4 "parallel"'s mapping,
//       a warp per tile, 8 tiles per block of 256 threads (313 blocks at
//       T = 2500), lane l storing float4 l and l + 32 of its tile, pixels
//       4l .. 4l+3 and 4l+128 .. 4l+131, whose columns n % 16 are both
//       4 (l % 4) + 0..3. The other 16,383 entries of the TPU kernel's
//       triangle reach no output; on the TPU each grid step built them, here
//       the function is computed and the triangle is not: the one entry read,
//       i < j at (0, 0), is a compare in registers. No shared memory, no
//       barrier. Measured in turns on an H100 80GB HBM3 at 700 W
//       (scripts.time_ms, T = 2500, ms, 12 readings each; torch.ones of the
//       same 2.56 MB 0.00256-0.00266): this mapping 0.00256-0.00259; 4 tiles
//       per block of 128 threads (625 blocks) 0.00255-0.00259, no faster in
//       5 of 6 rounds; the first port's kernel, a block per tile building
//       the triangle in 16 KB of shared memory behind a barrier,
//       0.02129-0.02132; a block per tile storing a float a thread without
//       the triangle 0.00360-0.00363. So on this card the triangle cost
//       0.0177 ms (7.1 ns a tile) and the block-per-tile mapping 0.0011 ms.
//   K10 kwl (:128-139, call :146): a warp per tile, kWarps tiles per block
//       of 256 threads. Each warp loads its tile's loop count s[t] (the TPU's
//       scalar prefetch; one 4-byte load for the warp, the block's 8 counts
//       adjacent), stores its tile's 256 ones [T,256,1] as two float4 a lane,
//       runs the loop of s[t] iterations, and stores zeros over its ones if
//       the counter did not end at max(s[t], 0), so a loop that ran wrong
//       shows in the output. An empty asm statement that takes the counter
//       as an in/out operand keeps the compiler from folding the loop into
//       c = s[t]. The JAX kernel's store does not depend on its loop; here
//       neither does the first store, so the load's latency overlaps the
//       stores (measured: with the store after the loop, or the block's
//       counts staged in shared memory behind a barrier, K10 took 0.2 us
//       more, 1.07-1.10x torch.ones). PR 3's mapping, one block per tile
//       whose first act was the dependent load of its s[t], launched 2500
//       blocks and lost 1.5x to torch.ones.
//
// Bound. Bytes written once: 2.56 MB for K4, K9 and K10 (about 0.76 us at
// 3.35 TB/s; K10 also reads s, 4 T bytes), 12.8 MB for K5-K8 (about 3.8 us).
// Both sit below the card's launch latency, so what these kernels measure is
// the launch and the per-block cost.

#include <cuda_runtime.h>

namespace {

constexpr int kN = 256;   // pixels per tile, threads per block
constexpr int kTile5 = kN * 5 / 4;   // float4 per tile of 5 floats a pixel
constexpr int kWarps = kN / 32;      // K4's, K9's and K10's tiles per block, a warp each
constexpr int kTiles5 = 4;           // K7's and K8's tiles per block, 20 KB

// K4 "parallel": a warp per tile, kWarps tiles per block, each lane storing
// two float4 of its tile's 64.
__global__ void __launch_bounds__(kN)
ones_parallel_kernel(float4* __restrict__ out, int num_tiles) {
  const int t = blockIdx.x * kWarps + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (t >= num_tiles) return;
  float4* o = out + (size_t)t * (kN / 4);
  const float4 ones = make_float4(1.0f, 1.0f, 1.0f, 1.0f);
  o[lane] = ones;
  o[lane + 32] = ones;
}

__global__ void __launch_bounds__(kN)
ones_sequential_kernel(float4* __restrict__ out, int num_tiles) {
  const int lane = threadIdx.x % 32;
  const float4 ones = make_float4(1.0f, 1.0f, 1.0f, 1.0f);
  for (int t = blockIdx.x * kWarps + threadIdx.x / 32; t < num_tiles;
       t += gridDim.x * kWarps) {
    float4* o = out + (size_t)t * (kN / 4);
    o[lane] = ones;
    o[lane + 32] = ones;
  }
}

__global__ void __launch_bounds__(kN)
ones_three_kernel(float* __restrict__ a, float* __restrict__ b,
                  float* __restrict__ c) {
  const size_t px = (size_t)blockIdx.x * kN + threadIdx.x;
  a[3 * px + 0] = 1.0f;
  a[3 * px + 1] = 1.0f;
  a[3 * px + 2] = 1.0f;
  b[px] = 1.0f;
  c[px] = 1.0f;
}

__global__ void __launch_bounds__(kN) ones_broadcast5_kernel(float4* __restrict__ out) {
  constexpr unsigned kAll = 0xffffffffu;
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float v = 1.0f;   // k1's (256, 1) value of this pixel
  // the warp's 32 pixels are the tile's floats [160 w, 160 w + 160): float4
  // j of them holds pixels (4 j) / 5 .. (4 j + 3) / 5 of the warp
  const int j = lane + 32;   // a lane's second float4, stored by lanes < 8
  float4 a, b;
  a.x = __shfl_sync(kAll, v, (4 * lane) / 5);
  a.y = __shfl_sync(kAll, v, (4 * lane + 1) / 5);
  a.z = __shfl_sync(kAll, v, (4 * lane + 2) / 5);
  a.w = __shfl_sync(kAll, v, (4 * lane + 3) / 5);
  b.x = __shfl_sync(kAll, v, ((4 * j) / 5) & 31);
  b.y = __shfl_sync(kAll, v, ((4 * j + 1) / 5) & 31);
  b.z = __shfl_sync(kAll, v, ((4 * j + 2) / 5) & 31);
  b.w = __shfl_sync(kAll, v, ((4 * j + 3) / 5) & 31);
  float4* o = out + (size_t)blockIdx.x * kTile5 + w * 40;
  o[lane] = a;
  if (lane < 8) o[j] = b;
}

// K7 and K8: a warp per unit of kUnit tiles (K7 a tile, K8 the TPU's pair),
// kPer units per block, so that a block writes 4 tiles (20 KB) in both. Lane
// l stores the unit's float4 l, l + 32, ... (10 a tile): each warp store
// covers 512 contiguous bytes.
template <int kUnit, int kPer>
__global__ void __launch_bounds__(kPer * 32)
ones5_warp_kernel(float4* __restrict__ out, int num_units) {
  const int u = blockIdx.x * kPer + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (u >= num_units) return;
  float4* o = out + (size_t)u * kUnit * kTile5 + lane;
  const float4 ones = make_float4(1.0f, 1.0f, 1.0f, 1.0f);
#pragma unroll
  for (int i = 0; i < kUnit * kTile5 / 32; ++i) o[32 * i] = ones;
}

// K9: K4 "parallel"'s warp per tile, storing each pixel's column plus the
// triangle's one entry that reaches the output.
__global__ void __launch_bounds__(kN)
iota_px_kernel(float4* __restrict__ out, int num_tiles) {
  const int t = blockIdx.x * kWarps + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (t >= num_tiles) return;
  constexpr int i = 0, j = 0;   // tri[0, 0]
  const float tri = (float)(i < j);
  const float c = (float)(4 * (lane % 4));   // the column of the float4's first pixel
  const float4 v = make_float4(c + tri * 1.0f, (c + 1.0f) + tri * 1.0f,
                               (c + 2.0f) + tri * 1.0f, (c + 3.0f) + tri * 1.0f);
  float4* o = out + (size_t)t * (kN / 4);
  o[lane] = v;
  o[lane + 32] = v;
}

__global__ void __launch_bounds__(kN)
while_ones_kernel(const int* __restrict__ s, float4* __restrict__ out, int num_tiles) {
  const int t = blockIdx.x * kWarps + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (t >= num_tiles) return;
  const int start = __ldg(s + t);   // issued first; nothing below waits on it
  float4* o = out + (size_t)t * (kN / 4);
  const float4 ones = make_float4(1.0f, 1.0f, 1.0f, 1.0f);
  o[lane] = ones;
  o[lane + 32] = ones;
  int c = 0;
  while (c < start) {
    c = c + 1;
    asm volatile("" : "+r"(c));
  }
  if (c != max(start, 0)) {   // a loop that ran wrong leaves zeros
    const float4 zeros = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    o[lane] = zeros;
    o[lane + 32] = zeros;
  }
}

}  // namespace

// Plain C interface, loaded with ctypes. Each entry point launches on
// `stream`, does not synchronise, allocates nothing and returns
// cudaGetLastError() of its launch; `num_tiles` is T.

// K4 "parallel": ceil(T / 8) blocks.
extern "C" int fourdgs_ones_parallel(float* out, int num_tiles, void* stream) {
  if (num_tiles <= 0) return 0;
  const int blocks = (num_tiles + kWarps - 1) / kWarps;
  ones_parallel_kernel<<<blocks, kN, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<float4*>(out), num_tiles);
  return (int)cudaGetLastError();
}

// K4 "arbitrary": `num_blocks` persistent blocks (the caller's grid).
extern "C" int fourdgs_ones_sequential(float* out, int num_tiles, int num_blocks,
                                       void* stream) {
  if (num_tiles <= 0) return 0;
  if (num_blocks <= 0) return (int)cudaErrorInvalidValue;
  ones_sequential_kernel<<<num_blocks, kN, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<float4*>(out), num_tiles);
  return (int)cudaGetLastError();
}

extern "C" int fourdgs_ones_three(float* a, float* b, float* c, int num_tiles,
                                  void* stream) {
  if (num_tiles <= 0) return 0;
  ones_three_kernel<<<num_tiles, kN, 0, (cudaStream_t)stream>>>(a, b, c);
  return (int)cudaGetLastError();
}

extern "C" int fourdgs_ones_broadcast5(float* out, int num_tiles, void* stream) {
  if (num_tiles <= 0) return 0;
  ones_broadcast5_kernel<<<num_tiles, kN, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<float4*>(out));
  return (int)cudaGetLastError();
}

// K7: a warp per tile, 4 tiles per block of 128 threads, ceil(T / 4) blocks.
extern "C" int fourdgs_ones5(float* out, int num_tiles, void* stream) {
  if (num_tiles <= 0) return 0;
  ones5_warp_kernel<1, kTiles5><<<(num_tiles + kTiles5 - 1) / kTiles5, kTiles5 * 32, 0,
                                  (cudaStream_t)stream>>>(
      reinterpret_cast<float4*>(out), num_tiles);
  return (int)cudaGetLastError();
}

// K8: a warp per pair of tiles (T even), 2 pairs per block of 64 threads,
// ceil(T / 4) blocks.
extern "C" int fourdgs_ones5_pairs(float* out, int num_tiles, void* stream) {
  const int pairs = num_tiles / 2;
  if (pairs <= 0) return 0;
  constexpr int kPairs = kTiles5 / 2;
  ones5_warp_kernel<2, kPairs><<<(pairs + kPairs - 1) / kPairs, kPairs * 32, 0,
                                 (cudaStream_t)stream>>>(
      reinterpret_cast<float4*>(out), pairs);
  return (int)cudaGetLastError();
}

// K9: ceil(T / 8) blocks.
extern "C" int fourdgs_iota_px(float* out, int num_tiles, void* stream) {
  if (num_tiles <= 0) return 0;
  const int blocks = (num_tiles + kWarps - 1) / kWarps;
  iota_px_kernel<<<blocks, kN, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<float4*>(out), num_tiles);
  return (int)cudaGetLastError();
}

extern "C" int fourdgs_while_ones(const int* s, float* out, int num_tiles,
                                  void* stream) {
  if (num_tiles <= 0) return 0;
  const int blocks = (num_tiles + kWarps - 1) / kWarps;
  while_ones_kernel<<<blocks, kN, 0, (cudaStream_t)stream>>>(
      s, reinterpret_cast<float4*>(out), num_tiles);
  return (int)cudaGetLastError();
}

extern "C" const char* fourdgs_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
