// k-pass minwise-hash signatures for Hopper (sm_90a): the paper's §3 GPU
// preprocessing kernel.
//
// Replaces the Pallas TPU kernels minhash2u_pallas / minhash4u_pallas
// (src/repro/kernels/minhash.py: _minhash2u_kernel, _minhash4u_kernel)
// and their fused epilogue pack_block (src/repro/kernels/pack.py).
//
// Bound: integer ALU operations -- n * nnz * k hash-and-min evaluations
// (2U: multiply-add, shift, min; 4U: three 64-bit Horner steps with
// BitMod), against only n * nnz * 4 bytes of indices.  Design: one block
// per (row, group of blockDim.x hash functions); each thread owns ONE
// hash function j, keeps its coefficients and its running minimum in
// registers, and the block stages the row's indices in shared memory
// TILE at a time (one coalesced global read per block), which every
// thread then reads as broadcast 16-byte loads: one shared load feeds
// four hash evaluations.  Lanes past counts[i] are never read, so they
// never win the min.  The epilogue masks to b bits and, when b | 32 and
// k is a multiple of blockDim.x, packs 32/b consecutive codes into one
// word with warp shuffles -- the lane-aligned layout of
// repro.core.bbit.pack_signatures, equal to the pack_codes bitstream.
#include <cuda_runtime.h>
#include "hash.cuh"

#define TILE 2048

template <bool FOUR_U>
__device__ __forceinline__ uint32_t hash_j(uint32_t t, uint32_t c0, uint32_t c1,
                                           uint32_t c2, uint32_t c3, int s,
                                           bool high) {
  return FOUR_U ? hash4u(t, c0, c1, c2, c3, s) : hash2u(t, c0, c1, s, high);
}

template <bool FOUR_U>
__global__ void minhash_kernel(const int32_t* __restrict__ idx,
                               const int32_t* __restrict__ counts, int nnz,
                               const uint32_t* __restrict__ ca,
                               const uint32_t* __restrict__ cb, int k, int s,
                               int high, int b, uint32_t* __restrict__ out,
                               uint32_t* __restrict__ packed, int words) {
  __shared__ __align__(16) int32_t tile[TILE];
  const int row = blockIdx.x;
  const int j = blockIdx.y * blockDim.x + threadIdx.x;
  const bool live = j < k;
  // 2U: ca = a1 (k,), cb = a2 (k,); 4U: ca = a (4, k) row-major
  uint32_t c0 = 0, c1 = 1, c2 = 0, c3 = 0;
  if (live) {
    if (FOUR_U) {
      c0 = ca[j]; c1 = ca[k + j]; c2 = ca[2 * k + j]; c3 = ca[3 * k + j];
    } else {
      c0 = ca[j]; c1 = cb[j];
    }
  }
  int cnt = counts[row];
  cnt = cnt < 0 ? 0 : (cnt > nnz ? nnz : cnt);
  const int32_t* r = idx + (size_t)row * nnz;
  const bool hi = high != 0;

  uint32_t m = SIG_EMPTY;
  for (int base = 0; base < cnt; base += TILE) {
    const int lim = min(TILE, cnt - base);
    __syncthreads();  // the previous tile is no longer read
    for (int q = threadIdx.x; q < lim; q += blockDim.x) tile[q] = r[base + q];
    __syncthreads();
    int q = 0;
    for (; q + 4 <= lim; q += 4) {
      const int4 v = *reinterpret_cast<const int4*>(&tile[q]);
      m = min(m, hash_j<FOUR_U>((uint32_t)v.x, c0, c1, c2, c3, s, hi));
      m = min(m, hash_j<FOUR_U>((uint32_t)v.y, c0, c1, c2, c3, s, hi));
      m = min(m, hash_j<FOUR_U>((uint32_t)v.z, c0, c1, c2, c3, s, hi));
      m = min(m, hash_j<FOUR_U>((uint32_t)v.w, c0, c1, c2, c3, s, hi));
    }
    for (; q < lim; ++q)
      m = min(m, hash_j<FOUR_U>((uint32_t)tile[q], c0, c1, c2, c3, s, hi));
  }
  if (b > 0 && b < 32) m &= (1u << b) - 1u;
  if (live) out[(size_t)row * k + j] = m;
  if (packed != nullptr) {
    // every lane is live here (k % blockDim.x == 0, checked by the wrapper)
    const int per = 32 / b, lane = threadIdx.x & 31;
    uint32_t w = m << ((lane % per) * b);
    for (int o = 1; o < per; o <<= 1) w |= __shfl_xor_sync(0xFFFFFFFFu, w, o);
    if (lane % per == 0) packed[(size_t)row * words + j / per] = w;
  }
}

template <bool FOUR_U>
static int launch(const void* idx, const void* counts, int n, int nnz,
                  const void* ca, const void* cb, int k, int s, int high, int b,
                  void* out, void* packed, int words, int threads,
                  void* stream) {
  dim3 grid(n, (k + threads - 1) / threads);
  minhash_kernel<FOUR_U><<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)idx, (const int32_t*)counts, nnz, (const uint32_t*)ca,
      (const uint32_t*)cb, k, s, high, b, (uint32_t*)out, (uint32_t*)packed,
      words);
  return (int)cudaGetLastError();
}

// packed may be null (no fused pack); words is its row stride.
extern "C" int minhash2u_launch(const void* idx, const void* counts, int n,
                                int nnz, const void* a1, const void* a2, int k,
                                int s, int high, int b, void* out, void* packed,
                                int words, int threads, void* stream) {
  return launch<false>(idx, counts, n, nnz, a1, a2, k, s, high, b, out, packed,
                       words, threads, stream);
}

extern "C" int minhash4u_launch(const void* idx, const void* counts, int n,
                                int nnz, const void* a, int k, int s, int b,
                                void* out, void* packed, int words, int threads,
                                void* stream) {
  return launch<true>(idx, counts, n, nnz, a, a, k, s, 1, b, out, packed, words,
                      threads, stream);
}
