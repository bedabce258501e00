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
//   K4  k1 (:49-50, call :53), ones [T,256,1].
//       "parallel": one block of 256 threads per tile (T blocks).
//       "arbitrary" (the sequential grid of one TPU core): a persistent loop,
//       one block per SM (the caller passes the SM count), each striding over
//       the tiles t = blockIdx.x, blockIdx.x + gridDim.x, ...
//   K5  k3 (:62-65, call :67), ones into three outputs [T,256,3], [T,256,1],
//       [T,256,1]: one block per tile, thread n writes its pixel of all three.
//   K6  k1 into a (1,256,5) block (call :78). The JAX kernel is ill-formed: it
//       stores a (256,1) value into a (256,5) block, which its trace rejects.
//       Ported as its intended function, the (256,1) value broadcast across
//       the 5 channels: thread n computes its pixel's value once and stores it
//       5 times (a stride-5 store per thread). Its output is K7's.
//   K7  k5 (:85-86, call :88), ones [T,256,5]: one block per tile fills its
//       1280 contiguous floats, thread n at n, n+256, ... (coalesced).
//   K8  kp (:97-98, call :100), ones [T,256,5], two tiles per grid step: one
//       block per pair of tiles fills 2560 contiguous floats (T even).
//   K9  kw (:111-117, call :119), out[t,n,0] = n % 16 + tri[0,0]: every block
//       builds the 128x128 strict upper triangle (i < j) in shared memory, as
//       every TPU grid step built its iotas, and adds its [0,0] entry (0).
//   K10 kwl (:128-139, call :146): block t loads its own s[t] (the TPU's
//       scalar prefetch), runs a loop of s[t] iterations, then writes ones
//       [T,256,1]. An empty asm statement that takes the counter as an in/out
//       operand keeps the compiler from folding the loop into c = s[t], and
//       the stored value is 1 only when the counter ended at max(s[t], 0), so
//       a loop that ran wrong shows in the output.
//
// Bound. Bytes written once: 2.56 MB for K4, K9 and K10 (about 0.76 us at
// 3.35 TB/s; K10 also reads s, 4 T bytes), 12.8 MB for K5-K8 (about 3.8 us).
// Both sit below the card's launch latency, so what these kernels measure is
// the launch and the per-block cost.

#include <cuda_runtime.h>

namespace {

constexpr int kN = 256;   // pixels per tile, threads per block
constexpr int kTri = 128;

__global__ void __launch_bounds__(kN) ones_parallel_kernel(float* __restrict__ out) {
  out[(size_t)blockIdx.x * kN + threadIdx.x] = 1.0f;
}

__global__ void __launch_bounds__(kN)
ones_sequential_kernel(float* __restrict__ out, int num_tiles) {
  for (int t = blockIdx.x; t < num_tiles; t += gridDim.x) {
    out[(size_t)t * kN + threadIdx.x] = 1.0f;
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

__global__ void __launch_bounds__(kN) ones_broadcast5_kernel(float* __restrict__ out) {
  const float v = 1.0f;   // k1's (256, 1) value of this pixel
  float* o = out + ((size_t)blockIdx.x * kN + threadIdx.x) * 5;
#pragma unroll
  for (int ch = 0; ch < 5; ++ch) o[ch] = v;
}

template <int kTiles>
__global__ void __launch_bounds__(kN) ones5_kernel(float* __restrict__ out) {
  float* o = out + (size_t)blockIdx.x * kTiles * kN * 5;
  for (int i = threadIdx.x; i < kTiles * kN * 5; i += kN) o[i] = 1.0f;
}

__global__ void __launch_bounds__(kN) iota_px_kernel(float* __restrict__ out) {
  __shared__ unsigned char tri[kTri][kTri];
  for (int e = threadIdx.x; e < kTri * kTri; e += kN) {
    tri[e / kTri][e % kTri] = (e / kTri) < (e % kTri);
  }
  __syncthreads();
  const int n = threadIdx.x;
  out[(size_t)blockIdx.x * kN + n] = (float)(n % 16) + (float)tri[0][0] * 1.0f;
}

__global__ void __launch_bounds__(kN)
while_ones_kernel(const int* __restrict__ s, float* __restrict__ out) {
  const int start = s[blockIdx.x];
  int c = 0;
  while (c < start) {
    c = c + 1;
    asm volatile("" : "+r"(c));
  }
  out[(size_t)blockIdx.x * kN + threadIdx.x] = (c == max(start, 0)) ? 1.0f : 0.0f;
}

}  // namespace

// Plain C interface, loaded with ctypes. Each entry point launches on
// `stream`, does not synchronise, allocates nothing and returns
// cudaGetLastError() of its launch; `num_tiles` is T.

extern "C" int fourdgs_ones_parallel(float* out, int num_tiles, void* stream) {
  if (num_tiles <= 0) return 0;
  ones_parallel_kernel<<<num_tiles, kN, 0, (cudaStream_t)stream>>>(out);
  return (int)cudaGetLastError();
}

extern "C" int fourdgs_ones_sequential(float* out, int num_tiles, int num_blocks,
                                       void* stream) {
  if (num_tiles <= 0) return 0;
  const int blocks = num_blocks < num_tiles ? num_blocks : num_tiles;
  ones_sequential_kernel<<<blocks, kN, 0, (cudaStream_t)stream>>>(out, num_tiles);
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
  ones_broadcast5_kernel<<<num_tiles, kN, 0, (cudaStream_t)stream>>>(out);
  return (int)cudaGetLastError();
}

extern "C" int fourdgs_ones5(float* out, int num_tiles, void* stream) {
  if (num_tiles <= 0) return 0;
  ones5_kernel<1><<<num_tiles, kN, 0, (cudaStream_t)stream>>>(out);
  return (int)cudaGetLastError();
}

extern "C" int fourdgs_ones5_pairs(float* out, int num_tiles, void* stream) {
  if (num_tiles <= 0) return 0;
  ones5_kernel<2><<<num_tiles / 2, kN, 0, (cudaStream_t)stream>>>(out);
  return (int)cudaGetLastError();
}

extern "C" int fourdgs_iota_px(float* out, int num_tiles, void* stream) {
  if (num_tiles <= 0) return 0;
  iota_px_kernel<<<num_tiles, kN, 0, (cudaStream_t)stream>>>(out);
  return (int)cudaGetLastError();
}

extern "C" int fourdgs_while_ones(const int* s, float* out, int num_tiles,
                                  void* stream) {
  if (num_tiles <= 0) return 0;
  while_ones_kernel<<<num_tiles, kN, 0, (cudaStream_t)stream>>>(s, out);
  return (int)cudaGetLastError();
}

extern "C" const char* fourdgs_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
