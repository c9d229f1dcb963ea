// Signature embedding-bag for Hopper (sm_90a): the Eq. (5) forward,
//
//     out[i, c] = sum_j table[j, tokens[i, j], c]     (fp32 accumulation)
//
// Replaces the Pallas TPU kernel sigbag_pallas
// (src/repro/kernels/sigbag.py: _sigbag_kernel).  The TPU kernel forms a
// one-hot (rows, 2^b) x (2^b, d) MXU product per slot j and accumulates
// over the grid's sequential j axis; on Hopper the same function is a
// gather-sum.
//
// Result, bit for bit: each output element is a float32 sum that starts
// at 0 and adds slot j's value in the order j = 0, 1, ..., k-1 with plain
// round-to-nearest adds (__fadd_rn, never contracted), cast once at the
// end to the table's type -- what the Pallas kernel computes.  A token
// outside [0, two_b) adds nothing (its one-hot row is all zero there).
//
// Bound: bytes.  Each (row, slot) reads one d-wide table row, so the
// kernel reads n*k*d values while the table itself (k * 2^b * d, 2 MB for
// the recsys frontend) sits in L2; the least work is the tokens and the
// table read once and the output written once.  Design: one warp per row,
// one lane per column (columns looped in steps of 32 for d > 32).  The
// warp reads its row's tokens 32 at a time, one per lane (coalesced), and
// broadcasts them with __shfl_sync; each lane then issues the 32 slots'
// loads through the read-only path before it adds them in order, so 32
// independent loads are in flight per thread.  A slot row of d = 32
// float32 columns is one 128-byte line per warp.  No atomics, no shared
// state between warps: the sums are deterministic.
//
// Left for later work: staging slot tables in shared memory, vector
// loads, several rows per warp for small d.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define WARPS 8               // rows per block
#define LANES 32

struct F32 {
  typedef float T;
  static __device__ __forceinline__ float load(const float* p) {
    return __ldg(p);
  }
  static __device__ __forceinline__ float store(float x) { return x; }
};

struct BF16 {
  typedef unsigned short T;   // the bf16 bit pattern
  static __device__ __forceinline__ float load(const unsigned short* p) {
    return __uint_as_float((uint32_t)__ldg(p) << 16);   // exact widening
  }
  static __device__ __forceinline__ unsigned short store(float x) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(x));
  }
};

template <class D>
__global__ void __launch_bounds__(WARPS * LANES)
sigbag_kernel(const int32_t* __restrict__ tokens,
              const typename D::T* __restrict__ table, int n, int k,
              int two_b, int d, typename D::T* __restrict__ out) {
  const int lane = threadIdx.x & (LANES - 1);
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= n) return;                      // uniform across the warp
  const int32_t* tok = tokens + (size_t)row * k;
  for (int c0 = 0; c0 < d; c0 += LANES) {
    const int c = c0 + lane;
    const bool live = c < d;
    float acc = 0.0f;
    for (int j0 = 0; j0 < k; j0 += LANES) {
      const int mine = j0 + lane < k ? tok[j0 + lane] : -1;
      float v[LANES];
#pragma unroll
      for (int jj = 0; jj < LANES; ++jj) {
        const int t = __shfl_sync(0xFFFFFFFFu, mine, jj);
        // t = -1 past k; acc is never -0, so adding +0 leaves it as is
        v[jj] = (live && (unsigned)t < (unsigned)two_b)
                    ? D::load(table + ((size_t)(j0 + jj) * two_b + t) * d + c)
                    : 0.0f;
      }
#pragma unroll
      for (int jj = 0; jj < LANES; ++jj) acc = __fadd_rn(acc, v[jj]);
    }
    if (live) out[(size_t)row * d + c] = D::store(acc);
  }
}

// bf16 != 0: table and out hold bfloat16, else float32.
extern "C" int sigbag_launch(const void* tokens, const void* table, int n,
                             int k, int two_b, int d, int bf16, void* out,
                             void* stream) {
  const dim3 grid((n + WARPS - 1) / WARPS);
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    sigbag_kernel<BF16><<<grid, WARPS * LANES, 0, s>>>(
        (const int32_t*)tokens, (const unsigned short*)table, n, k, two_b, d,
        (unsigned short*)out);
  else
    sigbag_kernel<F32><<<grid, WARPS * LANES, 0, s>>>(
        (const int32_t*)tokens, (const float*)table, n, k, two_b, d,
        (float*)out);
  return (int)cudaGetLastError();
}
