// Column gather for Hopper (sm_90a), the port of the TPU kernel
// scripts/exp_gather.py::gk (body :88-90, pallas_call :93):
//   out[r, k] = table[r, idx[k]]     table [16, P] f32, idx [K] i32, out [16, K] f32
// the attribute-major payload gather of the rasterizer, as the cost
// experiment runs it.
//
// Design. The TPU kernel kept the whole 4 MB table in VMEM and gathered
// BLK = 2048 columns per grid step. A Hopper block has at most 227 KB of
// shared memory, so the table cannot be staged there; it fits in the 50 MB
// L2 instead, and the gather leaves it there: one thread per slot k reads
// idx[k] (coalesced), then the 16 values table[r, idx[k]] through the
// read-only path (each a 4-byte read of a random column, served from L2 once
// the table is resident), and stores out[r, k], coalesced across the warp for
// each row r. No shared memory, no atomics; each output element is written
// once. Ids outside [0, P) write NaN (jnp.take's fill mode) rather than read
// outside the table; the wrapper's plain version raises on them.
//
// Bound. Bytes: idx read once (4 K), out written once (64 K), the table read
// once (64 P): 30.9 MB at P = 65,536, K = 393,216, about 9.2 us at
// 3.35 TB/s; 146.8 MB (43.8 us) at K = 2,097,152. No float operations.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 16;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
gather_cols_kernel(const float* __restrict__ table,  // [16, P]
                   const int* __restrict__ idx,      // [K]
                   float* __restrict__ out,          // [16, K]
                   int p, int k) {
  const int slot = blockIdx.x * kThreads + threadIdx.x;
  if (slot >= k) return;
  const int j = idx[slot];
  const bool inside = j >= 0 && j < p;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    out[(size_t)r * k + slot] =
        inside ? __ldg(table + (size_t)r * p + j) : __int_as_float(0x7fc00000);
  }
}

}  // namespace

// Plain C interface, loaded with ctypes. Launches on `stream`, does not
// synchronise, allocates nothing; returns cudaGetLastError() of the launch.
extern "C" int fourdgs_gather_cols(const float* table, const int* idx,
                                   float* out, int p, int k, void* stream) {
  if (k <= 0) return 0;
  const int blocks = (k + kThreads - 1) / kThreads;
  gather_cols_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      table, idx, out, p, k);
  return (int)cudaGetLastError();
}

extern "C" const char* fourdgs_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
