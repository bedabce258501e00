// Column gather for Hopper (sm_90a), the port of the TPU kernel
// scripts/exp_gather.py::gk (body :88-90, pallas_call :93):
//   out[r, k] = table[r, idx[k]]     table [16, P] f32, idx [K] i32, out [16, K] f32
// the attribute-major payload gather of the rasterizer, as the cost
// experiment runs it.
//
// Design. The TPU kernel kept the whole 4 MB table in VMEM and gathered
// BLK = 2048 columns per grid step. A Hopper block has at most 227 KB of
// shared memory, so the table cannot be staged there; it fits in the 50 MB
// L2 instead. In the attribute-major table the 16 values of one id lie P
// floats apart, so a gather that reads them where they lie (the first port:
// a thread per slot, 16 four-byte loads) touches 16 lines per slot, and a
// warp load of 32 random ids 32 lines: the L1/L2 request rate, not the
// bytes, set its time (5.6x its bound, as index_select(1)). So the gather
// runs in two passes, both on the caller's stream:
//   1. Staging, [16, P] -> Gaussian-major rows [P, 16] (the wrapper's
//      scratch): a block takes a run of kStageCols columns, reads the 16
//      rows' segments coalesced, transposes them through padded shared
//      memory and writes the run's contiguous 64-byte rows as float4. Any
//      P: the last run is masked. Its first act lets the gather pass launch
//      (Hopper's programmatic dependent launch), so the gather's blocks are
//      resident and have loaded their ids when the rows are done.
//   2. Gather, a block per 256 slots: a quad of lanes per slot, lane q of
//      the quad loading float4 q of row idx[k], 64 bytes, 64-byte aligned,
//      inside one 128-byte line: one line per slot, and a warp instruction
//      covers 8 slots. The block's 16 x 256 values go through shared memory
//      ([16][256 + 4]) and, after one barrier, are stored row by row as
//      float4, out[r, k0 .. k0 + 255], 1 KB a row (scalar stores where K is
//      no multiple of 4 or the block is the last, partial one). The stores
//      are streaming (st.global.cs, evict first): out is written once and
//      not read here, so it leaves the L2 to the rows and the ids.
// No atomics; each output element is written once, so the result is
// index_select(1)'s bit for bit. Ids outside [0, P) write NaN (jnp.take's
// fill mode) rather than read outside the table; the wrapper's plain
// version raises on them.
//
// Measured against it (an H100 80GB HBM3 at 700 W, exp_gather.run()): each
// warp storing its own 32 slots' rows, 128 bytes a store (the same at
// P = 65,536, K = 393,216; its gather 5% slower at K = 2,097,152); the
// gather launched after the staging without the dependent launch (about
// 1.5 us more a call); plain stores in place of streaming ones (the call
// 10% slower at the script's shape, 3% at the render's); staging runs of
// 64 columns (within 0.0004 ms); a thread per slot loading its row's four
// float4 and storing its 16 values straight to out, no shared memory (its
// gather pass 0.0130 ms against 0.0106 at the script's shape; removed).
//
// fourdgs_gather_stage and fourdgs_gather_rows run one pass each: the
// wrapper's hooks, to time the passes apart. The gather pass on a [P, 16]
// table is the render path's index_select(0).T.contiguous().
//
// Bound. The function's bytes: idx read once (4 K), out written once
// (64 K), the table read once (64 P), whatever the staging re-reads: 30.9
// MB at P = 65,536, K = 393,216, about 9.2 us at 3.35 TB/s; 146.8 MB
// (43.8 us) at K = 2,097,152. No float operations.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 16;
constexpr int kThreads = 256;
constexpr int kStageCols = 128;          // columns per staging block
constexpr int kPad = 4;                  // the gather's [16][256 + kPad]
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ float4 nan4() {
  const float q = __int_as_float(0x7fc00000);
  return make_float4(q, q, q, q);
}

__global__ void __launch_bounds__(kThreads)
stage_rows_kernel(const float* __restrict__ table,  // [16, P]
                  float4* __restrict__ rows,        // [P, 16] as [P, 4] float4
                  int p) {
  __shared__ float s[kStageCols][kRows + 1];   // odd pitch: the column writes
  const int c0 = blockIdx.x * kStageCols;      // below hit 32 banks
  const int n = min(kStageCols, p - c0);
  // let the gather pass launch now; it waits for this grid's rows itself
  asm volatile("griddepcontrol.launch_dependents;");
  // element e = r * kStageCols + c: each warp reads 32 adjacent columns of a row
#pragma unroll
  for (int i = 0; i < kRows * kStageCols / kThreads; ++i) {
    const int e = i * kThreads + threadIdx.x;
    const int r = e / kStageCols, c = e % kStageCols;
    if (c < n) s[c][r] = __ldg(table + (size_t)r * p + c0 + c);
  }
  __syncthreads();
  // float4 f = 4 c + q of the run holds rows 4q .. 4q + 3 of column c0 + c
  for (int f = threadIdx.x; f < 4 * n; f += kThreads) {
    const int c = f / 4, r = 4 * (f % 4);
    rows[(size_t)c0 * 4 + f] = make_float4(s[c][r], s[c][r + 1], s[c][r + 2], s[c][r + 3]);
  }
}

__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const float4* __restrict__ rows,  // [P, 16] as [P, 4] float4
                   const int* __restrict__ idx,      // [K]
                   float* __restrict__ out,          // [16, K]
                   int p, int k) {
  __shared__ __align__(16) float s[kRows][kThreads + kPad];
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int k0 = blockIdx.x * kThreads;   // the block's slots k0 .. k0 + n - 1
  const int n = min(kThreads, k - k0);
  const int mine = (int)threadIdx.x < n ? __ldg(idx + k0 + threadIdx.x) : -1;
  // behind the staging pass (programmatic dependent launch): wait for its
  // rows here, after the ids' load; without it this returns at once
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int q = lane % 4;
  float4 v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {   // warp slot 8 i + lane / 4, float4 q of its row
    const int j = __shfl_sync(kAll, mine, 8 * i + lane / 4);
    v[i] = (j >= 0 && j < p) ? __ldg(rows + (size_t)j * 4 + q) : nan4();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int slot = 32 * w + 8 * i + lane / 4;
    s[4 * q + 0][slot] = v[i].x;
    s[4 * q + 1][slot] = v[i].y;
    s[4 * q + 2][slot] = v[i].z;
    s[4 * q + 3][slot] = v[i].w;
  }
  __syncthreads();
  if (n == kThreads && k % 4 == 0) {   // out[r, k0 ..] 16-byte aligned
#pragma unroll
    for (int e = threadIdx.x; e < kRows * kThreads / 4; e += kThreads) {
      const int r = e / (kThreads / 4), f = e % (kThreads / 4);
      __stcs(reinterpret_cast<float4*>(out + (size_t)r * k + k0) + f,
             reinterpret_cast<const float4*>(s[r])[f]);
    }
  } else {
    for (int e = threadIdx.x; e < kRows * n; e += kThreads) {
      const int r = e / n, c = e % n;
      __stcs(out + (size_t)r * k + k0 + c, s[r][c]);
    }
  }
}

int stage(const float* table, float* rows, int p, cudaStream_t stream) {
  if (p <= 0) return 0;
  const int blocks = (p + kStageCols - 1) / kStageCols;
  stage_rows_kernel<<<blocks, kThreads, 0, stream>>>(
      table, reinterpret_cast<float4*>(rows), p);
  return (int)cudaGetLastError();
}

int gather(const float* rows, const int* idx, float* out, int p, int k,
           bool after_stage, cudaStream_t stream) {
  if (k <= 0) return 0;
  const float4* r4 = reinterpret_cast<const float4*>(rows);
  const int blocks = (k + kThreads - 1) / kThreads;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = after_stage ? 1 : 0;
  const cudaError_t rc = cudaLaunchKernelEx(&cfg, gather_rows_kernel, r4, idx, out, p, k);
  return rc != cudaSuccess ? (int)rc : (int)cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes. Each entry point launches on
// `stream`, does not synchronise, allocates nothing (`rows` is the caller's
// [P, 16] float32 scratch, 16-byte aligned) and returns cudaGetLastError()
// of its launches.

// K3: stage, then gather.
extern "C" int fourdgs_gather_cols(const float* table, const int* idx, float* rows,
                                   float* out, int p, int k, void* stream) {
  if (k <= 0) return 0;
  const int rc = stage(table, rows, p, (cudaStream_t)stream);
  if (rc != 0) return rc;
  return gather(rows, idx, out, p, k, p > 0, (cudaStream_t)stream);
}

// The staging pass alone: rows [P, 16] = table [16, P] transposed.
extern "C" int fourdgs_gather_stage(const float* table, float* rows, int p,
                                    void* stream) {
  return stage(table, rows, p, (cudaStream_t)stream);
}

// The gather pass alone from a [P, 16] table.
extern "C" int fourdgs_gather_rows(const float* rows, const int* idx, float* out,
                                   int p, int k, void* stream) {
  return gather(rows, idx, out, p, k, false, (cudaStream_t)stream);
}

extern "C" const char* fourdgs_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
