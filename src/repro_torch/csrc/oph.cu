// One Permutation Hashing bin minima for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels oph2u_pallas / oph4u_pallas
// (src/repro/kernels/oph.py: _oph2u_kernel, _oph4u_kernel, _binned_min,
// _sentinel_codes).  The TPU version compares every (nonzero, bin) pair
// with a lane iota because a vector unit has no scatter; here each
// nonzero is hashed ONCE and scattered with a shared-memory atomicMin.
//
// Bound: device-memory bytes.  A row's indices are read once (4 bytes per
// nonzero) and each thread does one hash and one shared atomic per
// nonzero, far below the ALU and shared-memory rates.  Design: one block
// per row; threads stride over the row's first counts[i] indices so that
// neighbouring threads load neighbouring words (coalesced), and never
// touch the padding past counts[i]; the k bins live in shared memory
// (k * 4 bytes) and are written out once, as sentinel (b+1)-bit codes
// when code_b > 0 (EMPTY -> 2^code_b).
#include <cuda_runtime.h>
#include "hash.cuh"

template <bool FOUR_U>
__global__ void oph_kernel(const int32_t* __restrict__ idx,
                           const int32_t* __restrict__ counts, int nnz,
                           const uint32_t* __restrict__ ca,
                           const uint32_t* __restrict__ cb, int s,
                           int bin_bits, int high, int code_b,
                           uint32_t* __restrict__ out) {
  extern __shared__ uint32_t bins[];
  const int k = 1 << bin_bits;
  const int row = blockIdx.x;
  for (int j = threadIdx.x; j < k; j += blockDim.x) bins[j] = SIG_EMPTY;
  __syncthreads();

  int cnt = counts[row];
  cnt = cnt < 0 ? 0 : (cnt > nnz ? nnz : cnt);
  const int32_t* r = idx + (size_t)row * nnz;
  const int off_bits = s - bin_bits;
  const uint32_t off_mask = (off_bits >= 32) ? 0xFFFFFFFFu : ((1u << off_bits) - 1u);
  // 2U: ca = a1, cb = a2; 4U: ca = a[0..3] (Horner coefficients)
  uint32_t c0 = ca[0], c1 = FOUR_U ? ca[1] : cb[0], c2 = 0, c3 = 0;
  if (FOUR_U) { c2 = ca[2]; c3 = ca[3]; }
  for (int t = threadIdx.x; t < cnt; t += blockDim.x) {
    uint32_t x = (uint32_t)r[t];
    uint32_t h = FOUR_U ? hash4u(x, c0, c1, c2, c3, s) : hash2u(x, c0, c1, s, high);
    uint32_t bin = bin_bits > 0 ? (h >> off_bits) : 0u;
    atomicMin(&bins[bin], h & off_mask);
  }
  __syncthreads();

  uint32_t* o = out + (size_t)row * k;
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    uint32_t v = bins[j];
    if (code_b > 0) v = (v == SIG_EMPTY) ? (1u << code_b) : (v & ((1u << code_b) - 1u));
    o[j] = v;
  }
}

template <bool FOUR_U>
static int launch(const void* idx, const void* counts, int n, int nnz,
                  const void* ca, const void* cb, int s, int bin_bits, int high, int code_b,
                  void* out, int threads, void* stream) {
  size_t smem = sizeof(uint32_t) << bin_bits;
  oph_kernel<FOUR_U><<<n, threads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)idx, (const int32_t*)counts, nnz, (const uint32_t*)ca,
      (const uint32_t*)cb, s, bin_bits, high, code_b, (uint32_t*)out);
  return (int)cudaGetLastError();
}

// The ONE hash function: 2U (a1, a2), each (1,); 4U a, (4, 1).
extern "C" int oph2u_launch(const void* idx, const void* counts, int n, int nnz,
                            const void* a1, const void* a2, int s, int bin_bits,
                            int high, int code_b, void* out, int threads,
                            void* stream) {
  return launch<false>(idx, counts, n, nnz, a1, a2, s, bin_bits, high, code_b,
                       out, threads, stream);
}

extern "C" int oph4u_launch(const void* idx, const void* counts, int n, int nnz,
                            const void* a, int s, int bin_bits, int code_b,
                            void* out, int threads, void* stream) {
  return launch<true>(idx, counts, n, nnz, a, a, s, bin_bits, 1, code_b, out,
                      threads, stream);
}
