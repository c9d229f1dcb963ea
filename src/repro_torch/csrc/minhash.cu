// k-pass minwise-hash signatures for Hopper (sm_90a): the paper's §3 GPU
// preprocessing kernel.
//
// Replaces the Pallas TPU kernels minhash2u_pallas / minhash4u_pallas
// (src/repro/kernels/minhash.py: _minhash2u_kernel, _minhash4u_kernel)
// and their fused epilogue pack_block (src/repro/kernels/pack.py).
//
// Bound: integer operations -- n * nnz * k hash-and-min evaluations
// against only n * nnz * 4 bytes of indices.  A thread keeps JPT (or, at
// small k, one) functions' coefficients and running minima in
// registers, strided by blockDim.x; the block stages the row's nonzeros
// in shared memory a tile at a time (one coalesced global read), which
// every thread then reads as broadcast 16-byte loads.  Lanes past
// counts[i] are never read, so they never win the min.
//
//   * 2U (minhash2u_kernel): the least work is one IMAD per evaluation
//     (a1 + a2 t, mod 2^32) and half a three-input min.  The kernel keeps
//     the running min of that raw value and applies the variant once per
//     (row, j) in the epilogue: variant high's shift keeps order, so
//     min(v >> x) == (min v) >> x with x = 32 - s, and variant low runs on
//     coefficients shifted left by x, whose value (a1 << x) + (a2 << x) t
//     == v << x == (v & (2^s - 1)) << x (mod 2^32) orders the masked
//     hashes the same way; >> x gives back their min.  A row with no
//     nonzero keeps SIG_EMPTY unshifted (its shifted form, 2^s - 1, is a
//     real hash value); s == 32 shifts by 0.  Both variants run the same
//     loop, with no branch in it.  One block covers a row's k <= 512
//     functions (4 a thread at 128 threads), so the row's indices are read
//     from device memory once, and one 16-byte shared load of 4 nonzeros
//     feeds 16 evaluations in 4 independent min chains; the loop is
//     unrolled to four such loads.  Its SASS is exactly 64 IMAD, 32
//     VIMNMX3.U32 and 4 LDS.128 per 16 nonzeros, plus uniform-datapath
//     loop control.  On the H100 that issues at ~2.6 cycles per warp
//     evaluation (the SM clock at 1980 MHz throughout), not the 1.5 of
//     one instruction a cycle: IMAD and VIMNMX3 do not both issue at the
//     dispatch rate, so the kernel sits near 56% of a bound that counts
//     every instruction at that rate.  For k <= 128
//     (the recsys frontend's k = 64) a block is k rounded up to 32
//     threads, one function each, so none idles.
//   * 4U (minhash4u_kernel): Horner's rule costs three dependent 64-bit
//     BitMod steps per (nonzero, j), most of them on the integer ALU pipe,
//     which issues at half the dispatch rate.  Instead the block computes
//     t^2 and t^3 mod p ONCE per nonzero while it stages the tile (two
//     mulmods shared by all k functions) and each evaluation is three
//     IMAD.WIDE.U32 into one 64-bit sum and a single reduction
//     (powsum4u in hash.cuh).  Each thread owns JPT functions, strided by
//     blockDim.x, so one 16-byte shared load of (t, t^2, t^3) feeds JPT
//     evaluations.  Outside the domain where the two forms agree
//     (coefficients < p, t < 2^31) the kernel keeps Horner (hash4u): a
//     thread with a coefficient >= p takes it for all its functions, and a
//     tile holding an index >= 2^31 (as uint32) takes it for the whole
//     block, a flag set while staging.  So the output is bit-equal to
//     hash4u for every input, with no host check.  Two nonzeros a step let
//     each running min take one VIMNMX3 per two evaluations.  In SASS an
//     evaluation is still about 8.5 integer-ALU instructions (the 64-bit
//     reduction's LOP3, SHF, IADD3, LEA.HI.X and VIADDMNMX, the mask, the
//     min) beside 3 IMAD.WIDE.U32 on the FMA pipe: the ALU pipe, at half
//     the dispatch rate, sets the pace.
//
// The epilogue masks to b bits and, when b | 32, packs 32/b consecutive
// codes into one word with warp shuffles -- the lane-aligned layout of
// repro.core.bbit.pack_signatures, equal to the pack_codes bitstream.  A
// warp's 32 functions are 32 consecutive j (the stride is a multiple of
// 32), so a word never spans two warps.  At a ragged k the last live warp
// packs too: its lanes past k give 0, and a word is stored only where its
// first code is live, so a row gets exactly ceil(k b / 32) words, zero
// padded, and nothing lands past its end (the next row's first words).
#include <cuda_runtime.h>
#include "hash.cuh"

#define TILE 2048   // 2U: indices staged per step
#define TILE4 1024  // 4U: nonzeros staged per step, 16 bytes each
#define JPT 4       // hash functions per thread (2U at k > one group, 4U)

// Pack 32/b consecutive codes of a warp's lanes into one word.  Every
// lane of the warp calls it, and its first lane's code is live (j < k);
// a lane past k gives 0, and a word whose first code is past k is not
// stored.
__device__ __forceinline__ void pack_codes_warp(uint32_t m, int b, int j,
                                                int k,
                                                uint32_t* __restrict__ prow) {
  const int per = 32 / b, lane = threadIdx.x & 31;
  uint32_t w = (j < k ? m : 0u) << ((lane % per) * b);
  for (int o = 1; o < per; o <<= 1) w |= __shfl_xor_sync(0xFFFFFFFFu, w, o);
  if (lane % per == 0 && j < k) prow[j / per] = w;
}

// 2U, J functions a thread: the running min of the raw a1 + a2 t, one
// shift per (row, j) after it (see the note at the top).
template <int J>
__global__ void minhash2u_kernel(const int32_t* __restrict__ idx,
                                 const int32_t* __restrict__ counts, int nnz,
                                 const uint32_t* __restrict__ ca,
                                 const uint32_t* __restrict__ cb, int k, int s,
                                 int high, int b, uint32_t* __restrict__ out,
                                 uint32_t* __restrict__ packed, int words) {
  __shared__ __align__(16) int32_t tile[TILE];
  const int row = blockIdx.x;
  const int j0 = blockIdx.y * blockDim.x * J + threadIdx.x;
  const int x = s < 32 ? 32 - s : 0;  // the epilogue's shift
  const int pre = high ? 0 : x;       // variant low: coefficients << x
  uint32_t c0[J], c1[J], m[J];
#pragma unroll
  for (int u = 0; u < J; ++u) {
    const int j = j0 + u * blockDim.x;
    c0[u] = c1[u] = 0u;
    if (j < k) {
      c0[u] = ca[j] << pre; c1[u] = cb[j] << pre;
    }
    m[u] = SIG_EMPTY;
  }
  int cnt = counts[row];
  cnt = cnt < 0 ? 0 : (cnt > nnz ? nnz : cnt);
  const int32_t* r = idx + (size_t)row * nnz;

  for (int base = 0; base < cnt; base += TILE) {
    const int lim = min(TILE, cnt - base);
    __syncthreads();  // the previous tile is no longer read
    for (int q = threadIdx.x; q < lim; q += blockDim.x) tile[q] = r[base + q];
    __syncthreads();
    int q = 0;
    // one 16-byte load feeds 4*J evaluations; two values per min; four
    // loads an iteration keep the loop's own instructions few
#pragma unroll 4
    for (; q + 4 <= lim; q += 4) {
      const uint4 v = *reinterpret_cast<const uint4*>(&tile[q]);
#pragma unroll
      for (int u = 0; u < J; ++u) {
        m[u] = min(m[u], min(c0[u] + c1[u] * v.x, c0[u] + c1[u] * v.y));
        m[u] = min(m[u], min(c0[u] + c1[u] * v.z, c0[u] + c1[u] * v.w));
      }
    }
    for (; q < lim; ++q) {
      const uint32_t t = (uint32_t)tile[q];
#pragma unroll
      for (int u = 0; u < J; ++u) m[u] = min(m[u], c0[u] + c1[u] * t);
    }
  }
#pragma unroll
  for (int u = 0; u < J; ++u) {
    const int j = j0 + u * blockDim.x;
    uint32_t v = cnt > 0 ? m[u] >> x : SIG_EMPTY;
    if (b > 0 && b < 32) v &= (1u << b) - 1u;
    if (j < k) out[(size_t)row * k + j] = v;
    // a warp packs when its first lane is live (j & ~31: the warp's first j)
    if (packed != nullptr && (j & ~31) < k)
      pack_codes_warp(v, b, j, k, packed + (size_t)row * words);
  }
}

__global__ void minhash4u_kernel(const int32_t* __restrict__ idx,
                                 const int32_t* __restrict__ counts, int nnz,
                                 const uint32_t* __restrict__ a, int k, int s,
                                 int b, uint32_t* __restrict__ out,
                                 uint32_t* __restrict__ packed, int words) {
  __shared__ uint4 xs[TILE4];  // (t, t^2 mod p, t^3 mod p, 0)
  const int row = blockIdx.x;
  const int j0 = blockIdx.y * blockDim.x * JPT + threadIdx.x;
  // a is (4, k) row-major: a[0] + a[1] t + a[2] t^2 + a[3] t^3
  uint32_t c0[JPT], c1[JPT], c2[JPT], c3[JPT];
  bool in_domain = true;
#pragma unroll
  for (int u = 0; u < JPT; ++u) {
    const int j = j0 + u * blockDim.x;
    c0[u] = c1[u] = c2[u] = c3[u] = 0u;
    if (j < k) {
      c0[u] = a[j]; c1[u] = a[k + j]; c2[u] = a[2 * k + j]; c3[u] = a[3 * k + j];
    }
    in_domain &= max(max(c0[u], c1[u]), max(c2[u], c3[u])) < MERSENNE_P;
  }
  int cnt = counts[row];
  cnt = cnt < 0 ? 0 : (cnt > nnz ? nnz : cnt);
  const int32_t* r = idx + (size_t)row * nnz;
  // s == 31: the residue is canonical, so hash4u's "% p" changes nothing
  const uint32_t smask = s < 31 ? (1u << s) - 1u : 0xFFFFFFFFu;

  uint32_t m[JPT];
#pragma unroll
  for (int u = 0; u < JPT; ++u) m[u] = SIG_EMPTY;
  for (int base = 0; base < cnt; base += TILE4) {
    const int lim = min(TILE4, cnt - base);
    __syncthreads();  // the previous tile is no longer read
    uint32_t wide = 0;
    for (int q = threadIdx.x; q < lim; q += blockDim.x) {
      const uint32_t t = (uint32_t)r[base + q];
      wide |= t >> 31;
      // t^2, t^3 mod p: BitMod products, canonical for t < 2^31
      const uint32_t t2 = bitmod_step(t, t, 0u);
      xs[q] = make_uint4(t, t2, bitmod_step(t2, t, 0u), 0u);
    }
    const bool horner = __syncthreads_or(wide) || !in_domain;
    if (!horner) {
      // two nonzeros a step, so each running min is one VIMNMX3 per pair
      int q = 0;
      for (; q + 2 <= lim; q += 2) {
        const uint4 x = xs[q], y = xs[q + 1];
#pragma unroll
        for (int u = 0; u < JPT; ++u)
          m[u] = min(m[u], min(powsum4u(x.x, x.y, x.z, c0[u], c1[u], c2[u],
                                        c3[u]) & smask,
                               powsum4u(y.x, y.y, y.z, c0[u], c1[u], c2[u],
                                        c3[u]) & smask));
      }
      if (q < lim) {
        const uint4 x = xs[q];
#pragma unroll
        for (int u = 0; u < JPT; ++u)
          m[u] = min(m[u], powsum4u(x.x, x.y, x.z, c0[u], c1[u], c2[u], c3[u])
                               & smask);
      }
    } else {
      for (int q = 0; q < lim; ++q) {
        const uint32_t t = xs[q].x;
#pragma unroll
        for (int u = 0; u < JPT; ++u)
          m[u] = min(m[u], hash4u(t, c0[u], c1[u], c2[u], c3[u], s));
      }
    }
  }
#pragma unroll
  for (int u = 0; u < JPT; ++u) {
    const int j = j0 + u * blockDim.x;
    uint32_t v = m[u];
    if (b > 0 && b < 32) v &= (1u << b) - 1u;
    if (j < k) out[(size_t)row * k + j] = v;
    // a warp packs when its first lane is live (j & ~31: the warp's first j)
    if (packed != nullptr && (j & ~31) < k)
      pack_codes_warp(v, b, j, k, packed + (size_t)row * words);
  }
}

// packed may be null (no fused pack); words is its row stride, at least
// ceil(k b / 32).  threads is
// the group size, a multiple of 32 (cut to k rounded up to 32 when k is
// smaller).  A thread takes one function when one group covers k (the
// recsys frontend's k = 64), else JPT groups, so one block covers a row's
// k <= JPT * threads functions (the paper's k = 500, 512) and reads its
// indices once; a larger k takes more blocks a row.
extern "C" int minhash2u_launch(const void* idx, const void* counts, int n,
                                int nnz, const void* a1, const void* a2, int k,
                                int s, int high, int b, void* out, void* packed,
                                int words, int threads, void* stream) {
  const int bd = min(threads, (k + 31) / 32 * 32);
  const int j = k <= bd ? 1 : JPT;
  const dim3 grid(n, (k + bd * j - 1) / (bd * j));
  auto kernel = j == 1 ? minhash2u_kernel<1> : minhash2u_kernel<JPT>;
  kernel<<<grid, bd, 0, (cudaStream_t)stream>>>(
      (const int32_t*)idx, (const int32_t*)counts, nnz, (const uint32_t*)a1,
      (const uint32_t*)a2, k, s, high, b, (uint32_t*)out, (uint32_t*)packed,
      words);
  return (int)cudaGetLastError();
}

// threads functions per group, JPT groups per block.
extern "C" int minhash4u_launch(const void* idx, const void* counts, int n,
                                int nnz, const void* a, int k, int s, int b,
                                void* out, void* packed, int words, int threads,
                                void* stream) {
  const dim3 grid(n, (k + threads * JPT - 1) / (threads * JPT));
  minhash4u_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)idx, (const int32_t*)counts, nnz, (const uint32_t*)a, k,
      s, b, (uint32_t*)out, (uint32_t*)packed, words);
  return (int)cudaGetLastError();
}
