// Packed-signature match counts for Hopper (sm_90a): the retrieval
// scoring kernel.
//
// Replaces the Pallas TPU kernel packed_match_pallas
// (src/repro/kernels/hamming.py: _hamming_kernel, _extract_codes).
//
// For every (query, doc) pair it counts how many of the first k
// code_bits-wide codes agree.  Both operands are packed in one bitstream
// layout (code j at bits [j*cb, (j+1)*cb) of the row), so a code matches
// exactly when its field of q ^ c is all zero.  With SENTINEL (code
// 2^(cb-1) marks an EMPTY bin) jointly-EMPTY positions are left out of
// the matches and counted in a second output.
//
// Bound: integer operations.  Each (query, doc, word) costs a handful of
// 32-bit lane instructions against 4 bytes per doc word read once, so the
// corpus stream is cheap next to the compare work.  Design: one block per
// (BQ x BN) output tile; the TPU grid's sequential k axis becomes a loop
// over word steps of TW words inside the block.  Each step stages the
// query and corpus word tiles in shared memory (one coalesced read per
// tile, the row stride odd so the threads of a warp hit distinct banks),
// and each thread keeps the counts of its QPT x NPT pairs in registers.
//   * code_bits | 32 (b = 8 on the usual wire): a SWAR zero-field count
//     per word -- the high bit of every all-zero field of x = q ^ c is
//     ~(((x & lo) + lo) | x) & hi, and __popc counts them.  The last
//     word's fields past k are masked off.
//   * any other width (9 bits for sentinel b = 8): codes straddle words,
//     so each code is pulled out of its word pair with __funnelshift_r,
//     the same two-shift rule as _extract_codes; a step stages one word
//     past its end for the codes that start in its last word.  The
//     fields are extracted once per (query, code) and (doc, code) and
//     compared once per pair.
// Codes past k never count.  Outputs are int32, written once per pair by
// the thread that owns it: no atomics, so the counts are deterministic
// and bit-exact against the plain version.
//
// Left for later work: tensor-core (one-hot) products and a fused
// Theorem-1 debias + running top-k epilogue.
#include <cuda_runtime.h>
#include <stdint.h>

#define BQ 32                 // queries per output tile
#define BN 64                 // docs per output tile
#define TW 32                 // words staged per step
#define STRIDE (TW + 1)       // + the word after the step; odd: no bank conflicts
#define THREADS 256           // 16 x 16 threads
#define QPT (BQ / 16)         // queries per thread
#define NPT (BN / 16)         // docs per thread

__device__ __forceinline__ uint32_t zero_fields(uint32_t x, uint32_t hi,
                                                uint32_t lo) {
  // lo: the low cb-1 bits of every field, hi: the top bit of every field.
  // (x & lo) + lo carries into the top bit iff the low bits are not all
  // zero, and never out of the field.
  return ~(((x & lo) + lo) | x) & hi;
}

template <bool SWAR, bool SENTINEL>
__global__ void __launch_bounds__(THREADS)
hamming_kernel(const uint32_t* __restrict__ q, const uint32_t* __restrict__ c,
               int nq, int nc, int W, int k, int cb, uint32_t hi, uint32_t lo,
               uint32_t last_mask, int32_t* __restrict__ matches,
               int32_t* __restrict__ both) {
  __shared__ uint32_t qs[BQ][STRIDE];
  __shared__ uint32_t cs[BN][STRIDE];
  const int q0 = blockIdx.y * BQ, n0 = blockIdx.x * BN;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  int32_t m[QPT][NPT], e[QPT][NPT];
#pragma unroll
  for (int a = 0; a < QPT; ++a)
#pragma unroll
    for (int d = 0; d < NPT; ++d) m[a][d] = e[a][d] = 0;
  const uint32_t fmask = cb >= 32 ? 0xFFFFFFFFu : (1u << cb) - 1u;
  const uint32_t ecode = 1u << (cb - 1);

  for (int w0 = 0; w0 < W; w0 += TW) {
    __syncthreads();  // the previous step's tiles are no longer read
    for (int i = threadIdx.x; i < BQ * STRIDE; i += THREADS) {
      const int r = i / STRIDE, w = i % STRIDE;
      qs[r][w] = (q0 + r < nq && w0 + w < W)
                     ? q[(size_t)(q0 + r) * W + w0 + w] : 0u;
    }
    for (int i = threadIdx.x; i < BN * STRIDE; i += THREADS) {
      const int r = i / STRIDE, w = i % STRIDE;
      cs[r][w] = (n0 + r < nc && w0 + w < W)
                     ? c[(size_t)(n0 + r) * W + w0 + w] : 0u;
    }
    __syncthreads();
    const int wn = min(TW, W - w0);
    if (SWAR) {
      for (int w = 0; w < wn; ++w) {
        const uint32_t valid = (w0 + w == W - 1) ? last_mask : 0xFFFFFFFFu;
        uint32_t qv[QPT], qe[QPT], cv[NPT];
#pragma unroll
        for (int a = 0; a < QPT; ++a) {
          qv[a] = qs[ty + 16 * a][w];
          // fields of q equal to the EMPTY code 2^(cb-1) == hi's field
          qe[a] = SENTINEL ? zero_fields(qv[a] ^ hi, hi, lo) : 0u;
        }
#pragma unroll
        for (int d = 0; d < NPT; ++d) cv[d] = cs[tx + 16 * d][w];
#pragma unroll
        for (int a = 0; a < QPT; ++a)
#pragma unroll
          for (int d = 0; d < NPT; ++d) {
            const uint32_t z = zero_fields(qv[a] ^ cv[d], hi, lo) & valid;
            if (SENTINEL) {
              e[a][d] += __popc(z & qe[a]);
              m[a][d] += __popc(z & ~qe[a]);
            } else {
              m[a][d] += __popc(z);
            }
          }
      }
    } else {
      // the codes whose first bit lies in this step's words
      const int bit0 = w0 * 32;
      const int j_lo = (bit0 + cb - 1) / cb;
      const int j_hi = min(k, ((w0 + wn) * 32 + cb - 1) / cb);
      for (int j = j_lo; j < j_hi; ++j) {
        const int bit = j * cb - bit0, wl = bit >> 5, sh = bit & 31;
        uint32_t fq[QPT];
#pragma unroll
        for (int a = 0; a < QPT; ++a) {
          const int r = ty + 16 * a;
          fq[a] = __funnelshift_r(qs[r][wl], qs[r][wl + 1], sh) & fmask;
        }
#pragma unroll
        for (int d = 0; d < NPT; ++d) {
          const int r = tx + 16 * d;
          const uint32_t fc =
              __funnelshift_r(cs[r][wl], cs[r][wl + 1], sh) & fmask;
#pragma unroll
          for (int a = 0; a < QPT; ++a) {
            const int eq = fq[a] == fc;
            if (SENTINEL) {
              const int emp = fq[a] == ecode;
              e[a][d] += eq & emp;
              m[a][d] += eq & !emp;
            } else {
              m[a][d] += eq;
            }
          }
        }
      }
    }
  }
#pragma unroll
  for (int a = 0; a < QPT; ++a)
#pragma unroll
    for (int d = 0; d < NPT; ++d) {
      const int qq = q0 + ty + 16 * a, nn = n0 + tx + 16 * d;
      if (qq < nq && nn < nc) {
        matches[(size_t)qq * nc + nn] = m[a][d];
        if (SENTINEL) both[(size_t)qq * nc + nn] = e[a][d];
      }
    }
}

template <bool SWAR, bool SENTINEL>
static void launch(dim3 grid, cudaStream_t stream, const void* q,
                   const void* c, int nq, int nc, int W, int k, int cb,
                   uint32_t hi, uint32_t lo, uint32_t last_mask, void* matches,
                   void* both) {
  hamming_kernel<SWAR, SENTINEL><<<grid, THREADS, 0, stream>>>(
      (const uint32_t*)q, (const uint32_t*)c, nq, nc, W, k, cb, hi, lo,
      last_mask, (int32_t*)matches, (int32_t*)both);
}

// q (nq, W) and c (nc, W) packed words; matches (nq, nc) int32; both
// (nq, nc) int32 or null unless sentinel.  hi / lo are the per-field
// masks of zero_fields and last_mask the valid bits of word W-1; the
// wrapper computes them (repro_torch/kernels/hamming.py).
extern "C" int packed_match_launch(const void* q, const void* c, int nq,
                                   int nc, int W, int k, int cb, int sentinel,
                                   uint32_t hi, uint32_t lo,
                                   uint32_t last_mask, void* matches,
                                   void* both, void* stream) {
  const dim3 grid((nc + BN - 1) / BN, (nq + BQ - 1) / BQ);
  const cudaStream_t s = (cudaStream_t)stream;
  const bool swar = 32 % cb == 0;
  if (swar && sentinel)
    launch<true, true>(grid, s, q, c, nq, nc, W, k, cb, hi, lo, last_mask,
                       matches, both);
  else if (swar)
    launch<true, false>(grid, s, q, c, nq, nc, W, k, cb, hi, lo, last_mask,
                        matches, both);
  else if (sentinel)
    launch<false, true>(grid, s, q, c, nq, nc, W, k, cb, hi, lo, last_mask,
                        matches, both);
  else
    launch<false, false>(grid, s, q, c, nq, nc, W, k, cb, hi, lo, last_mask,
                         matches, both);
  return (int)cudaGetLastError();
}
