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
// corpus stream is cheap next to the compare work.  Two kernels, one
// block per output tile each; the TPU grid's sequential k axis becomes a
// loop over word steps inside the block.
//
//   * swar_kernel, code_bits | 32 (b = 8 on the usual wire).  The high
//     bit of every all-zero field of x = q ^ c is ~(((x & lo) + lo) | x)
//     & hi.  Those flag bits sit at each field's top bit, so the flag
//     words of code_bits consecutive words, shifted right by 0 ..
//     code_bits - 1, have disjoint bits: they are added into one word and
//     counted by ONE __popc per code_bits words (POPC issues at a quarter
//     of the ALU rate), and likewise the EMPTY part of a sentinel wire.
//     The last word's fields past k are made unmatchable once, while
//     staging (the query's set to ones, the doc's to zeros; pad words past
//     W to ones in the query), so no word in the loop takes a mask.  Each
//     thread holds 4 x 8 pairs in registers, reading 16-byte vectors (4
//     words of one row) from row-major tiles whose stride of 36 words puts
//     8 consecutive rows on 32 distinct banks: 3 shared loads per word for
//     32 pairs.  Word steps are double-buffered with cp.async, so the next
//     step's global reads overlap this step's compare.  64 x 64 tiles give
//     the 256-query, 4,096-doc flush launch 256 blocks of 128 threads on
//     132 SMs.  What is left bounds it: in SASS a pair's word is three
//     LOP3, an add and one LEA.HI, four of them on the integer ALU pipe,
//     which takes 64 lanes a clock per SM, half the dispatch rate the
//     bound counts; that caps the kernel near 62% of its bound.
//   * straddle_kernel, any other width (9 bits for sentinel b = 8): codes
//     straddle words, so each code is pulled out of its word pair with
//     __funnelshift_r, the same two-shift rule as _extract_codes; a step
//     stages one word past its end for the codes that start in its last
//     word.  The fields are extracted once per (query, code) and (doc,
//     code) and compared once per pair.
// Codes past k never count.  Outputs are int32, written once per pair by
// the thread that owns it: no atomics, so the counts are deterministic
// and bit-exact against the plain version.
//
// Output tiles.  Each kernel is built for a few output tiles (queries x
// docs), listed in SWAR_TILES / STRADDLE_TILES (their first is the
// default; repro_torch/kernels/hamming.py's HAMMING_TILES lists the same).
// A tile keeps its kernel's thread layout, so a thread of swar_kernel
// holds (SQ / 16) x (SN / 8) pairs and one of straddle_kernel (BQ / 16) x
// (BN / 16), never more than the default tile's 4 x 8 and 2 x 4.  Smaller
// tiles give a launch more blocks for the same work; each block then
// stages more rows per pair.  On the H100 none beat the defaults at an
// exact flush's launch or on the 9-bit sentinel wire (PERF.md, measured by
// chip_smoke.py phase 17).  packed_match_tiled_launch takes the tile (a
// TuningTable entry names it); packed_match_launch keeps its C signature
// and runs the default tiles.
//
// Left for later work: tensor-core (one-hot) products and a fused
// Theorem-1 debias + running top-k epilogue.
#include <cuda_runtime.h>
#include <stdint.h>

// ---- swar_kernel -------------------------------------------------------
#define SW 32                 // words staged per step
#define SSTRIDE (SW + 4)      // row stride: 16-byte aligned, conflict-free
#define STHREADS 128          // 16 (queries) x 8 (docs)
// (SQ, SN): queries and docs per output tile; a thread takes queries
// ty + 16 a and docs tx + 8 d
#define SWAR_TILES(X) X(64, 64) X(32, 64) X(64, 32) X(32, 32)

// ---- straddle_kernel ---------------------------------------------------
#define TW 32                 // words staged per step
#define STRIDE (TW + 1)       // + the word after the step; odd: no bank conflicts
#define THREADS 256           // 16 x 16 threads
// (BQ, BN): queries and docs per output tile; a thread takes queries
// ty + 16 a and docs tx + 16 d
#define STRADDLE_TILES(X) X(32, 64) X(64, 32) X(32, 32) X(16, 64)

__device__ __forceinline__ uint32_t zero_fields(uint32_t x, uint32_t hi,
                                                uint32_t lo) {
  // lo: the low cb-1 bits of every field, hi: the top bit of every field.
  // (x & lo) + lo carries into the top bit iff the low bits are not all
  // zero, and never out of the field.
  return ~(((x & lo) + lo) | x) & hi;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t word_of(const uint4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

// Copy word step st (words [st*SW, st*SW + SW)) of the block's query and
// doc rows into tile (query rows, then doc rows): 16-byte copies when vec
// (W % 4 == 0 and both operands 16-byte aligned), else 4-byte ones; rows
// and words out of range are zero-filled.
template <int SQ, int SN>
__device__ __forceinline__ void swar_stage(uint32_t (&tile)[SQ + SN][SSTRIDE],
                                           const uint32_t* __restrict__ q,
                                           const uint32_t* __restrict__ c,
                                           int nq, int nc, int W, int q0,
                                           int n0, int st, bool vec) {
  const int w0 = st * SW;
  const int per = vec ? SW / 4 : SW;  // copies per row
  for (int i = threadIdx.x; i < (SQ + SN) * per; i += STHREADS) {
    const int row = i / per, col = (i % per) * (vec ? 4 : 1);
    const bool is_q = row < SQ;
    const int g = is_q ? q0 + row : n0 + row - SQ;
    const bool ok = g < (is_q ? nq : nc) && w0 + col < W;
    const uint32_t* src =
        ok ? (is_q ? q : c) + (size_t)g * W + w0 + col : q;
    if (vec)
      cp_async16(&tile[row][col], src, ok ? 16 : 0);
    else
      cp_async4(&tile[row][col], src, ok ? 4 : 0);
  }
  cp_async_commit();
}

// The last step only, by the thread that staged each word: the fields of
// word W-1 past k never match (query bits set, doc bits cleared), nor do
// the zero-filled words past W (query words set to all ones).
template <int SQ, int SN>
__device__ __forceinline__ void swar_mask_tail(
    uint32_t (&tile)[SQ + SN][SSTRIDE], int W, int st, bool vec,
    uint32_t last_mask) {
  const int w0 = st * SW;
  const int per = vec ? SW / 4 : SW;
  for (int i = threadIdx.x; i < (SQ + SN) * per; i += STHREADS) {
    const int row = i / per, col = (i % per) * (vec ? 4 : 1);
    for (int u = 0; u < (vec ? 4 : 1); ++u) {
      const int w = w0 + col + u;
      uint32_t& v = tile[row][col + u];
      if (w == W - 1)
        v = row < SQ ? (v | ~last_mask) : (v & last_mask);
      else if (w >= W && row < SQ)
        v = 0xFFFFFFFFu;
    }
  }
}

template <int CB, bool SENTINEL, int SQ, int SN>
__global__ void __launch_bounds__(STHREADS)
swar_kernel(const uint32_t* __restrict__ q, const uint32_t* __restrict__ c,
            int nq, int nc, int W, uint32_t hi, uint32_t lo,
            uint32_t last_mask, int vec_copies, int32_t* __restrict__ matches,
            int32_t* __restrict__ both) {
  constexpr int SQPT = SQ / 16, SNPT = SN / 8;  // queries, docs a thread
  __shared__ __align__(16) uint32_t tiles[2][SQ + SN][SSTRIDE];
  const int q0 = blockIdx.y * SQ, n0 = blockIdx.x * SN;
  const int tx = threadIdx.x & 7, ty = threadIdx.x >> 3;
  const bool vec = vec_copies != 0;
  // words per unrolled group: whole folds of CB words and whole 16-byte
  // vectors, so every shift is a constant
  constexpr int GW = CB < 4 ? 4 : CB;
  uint32_t acc[SQPT][SNPT], acce[SQPT][SNPT];
  int32_t m[SQPT][SNPT], e[SQPT][SNPT];
#pragma unroll
  for (int a = 0; a < SQPT; ++a)
#pragma unroll
    for (int d = 0; d < SNPT; ++d) acc[a][d] = acce[a][d] = m[a][d] = e[a][d] = 0;

  const int steps = (W + SW - 1) / SW;
  swar_stage<SQ, SN>(tiles[0], q, c, nq, nc, W, q0, n0, 0, vec);
  for (int st = 0; st < steps; ++st) {
    uint32_t (&tile)[SQ + SN][SSTRIDE] = tiles[st & 1];
    if (st + 1 < steps) {
      // tiles[(st + 1) & 1] was last read in step st - 1, before its
      // closing __syncthreads
      swar_stage<SQ, SN>(tiles[(st + 1) & 1], q, c, nq, nc, W, q0, n0,
                         st + 1, vec);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
      swar_mask_tail<SQ, SN>(tile, W, st, vec, last_mask);
    }
    __syncthreads();
#pragma unroll 1
    for (int g = 0; g < SW; g += GW) {
#pragma unroll
      for (int c4 = 0; c4 < GW; c4 += 4) {
        uint4 qv[SQPT];
        uint32_t qe[SQPT][4];
#pragma unroll
        for (int a = 0; a < SQPT; ++a) {
          qv[a] = *reinterpret_cast<const uint4*>(&tile[ty + 16 * a][g + c4]);
#pragma unroll
          for (int i = 0; i < 4; ++i)  // fields equal to EMPTY == hi's field
            qe[a][i] = SENTINEL ? zero_fields(word_of(qv[a], i) ^ hi, hi, lo)
                                : 0u;
        }
#pragma unroll
        for (int d = 0; d < SNPT; ++d) {
          const uint4 cv =
              *reinterpret_cast<const uint4*>(&tile[SQ + tx + 8 * d][g + c4]);
#pragma unroll
          for (int a = 0; a < SQPT; ++a)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int w = c4 + i, sh = w % CB;
              const uint32_t z =
                  zero_fields(word_of(qv[a], i) ^ word_of(cv, i), hi, lo);
              acc[a][d] += z >> sh;
              if (SENTINEL) acce[a][d] += (z & qe[a][i]) >> sh;
              if ((w + 1) % CB == 0) {
                if (SENTINEL) {
                  const int pe = __popc(acce[a][d]);
                  e[a][d] += pe;
                  m[a][d] += __popc(acc[a][d]) - pe;
                  acce[a][d] = 0;
                } else {
                  m[a][d] += __popc(acc[a][d]);
                }
                acc[a][d] = 0;
              }
            }
        }
      }
    }
    __syncthreads();  // this tile is no longer read
  }
#pragma unroll
  for (int a = 0; a < SQPT; ++a)
#pragma unroll
    for (int d = 0; d < SNPT; ++d) {
      const int qq = q0 + ty + 16 * a, nn = n0 + tx + 8 * d;
      if (qq < nq && nn < nc) {
        matches[(size_t)qq * nc + nn] = m[a][d];
        if (SENTINEL) both[(size_t)qq * nc + nn] = e[a][d];
      }
    }
}

template <bool SENTINEL, int BQ, int BN>
__global__ void __launch_bounds__(THREADS)
straddle_kernel(const uint32_t* __restrict__ q, const uint32_t* __restrict__ c,
                int nq, int nc, int W, int k, int cb,
                int32_t* __restrict__ matches, int32_t* __restrict__ both) {
  constexpr int QPT = BQ / 16, NPT = BN / 16;   // queries, docs a thread
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

template <int CB, int SQ, int SN>
static void launch_swar_tile(bool sentinel, const void* q, const void* c,
                             int nq, int nc, int W, uint32_t hi, uint32_t lo,
                             uint32_t last_mask, void* matches, void* both,
                             cudaStream_t stream) {
  const dim3 grid((nc + SN - 1) / SN, (nq + SQ - 1) / SQ);
  const int vec = W % 4 == 0 && (((uintptr_t)q | (uintptr_t)c) & 15) == 0;
  if constexpr (CB >= 2) {  // 1-bit codes have no sentinel wire
    if (sentinel) {
      swar_kernel<CB, true, SQ, SN><<<grid, STHREADS, 0, stream>>>(
          (const uint32_t*)q, (const uint32_t*)c, nq, nc, W, hi, lo,
          last_mask, vec, (int32_t*)matches, (int32_t*)both);
      return;
    }
  }
  swar_kernel<CB, false, SQ, SN><<<grid, STHREADS, 0, stream>>>(
      (const uint32_t*)q, (const uint32_t*)c, nq, nc, W, hi, lo, last_mask,
      vec, (int32_t*)matches, (int32_t*)both);
}

// Launches the (blk_q, blk_n) tile of SWAR_TILES; false if there is none.
template <int CB>
static bool launch_swar(int blk_q, int blk_n, bool sentinel, const void* q,
                        const void* c, int nq, int nc, int W, uint32_t hi,
                        uint32_t lo, uint32_t last_mask, void* matches,
                        void* both, cudaStream_t stream) {
#define SWAR_CASE(TQ, TN)                                                   \
  if (blk_q == TQ && blk_n == TN) {                                         \
    launch_swar_tile<CB, TQ, TN>(sentinel, q, c, nq, nc, W, hi, lo,         \
                                 last_mask, matches, both, stream);         \
    return true;                                                            \
  }
  SWAR_TILES(SWAR_CASE)
#undef SWAR_CASE
  return false;
}

template <int BQ, int BN>
static void launch_straddle_tile(bool sentinel, const void* q, const void* c,
                                 int nq, int nc, int W, int k, int cb,
                                 void* matches, void* both,
                                 cudaStream_t stream) {
  const dim3 grid((nc + BN - 1) / BN, (nq + BQ - 1) / BQ);
  if (sentinel)
    straddle_kernel<true, BQ, BN><<<grid, THREADS, 0, stream>>>(
        (const uint32_t*)q, (const uint32_t*)c, nq, nc, W, k, cb,
        (int32_t*)matches, (int32_t*)both);
  else
    straddle_kernel<false, BQ, BN><<<grid, THREADS, 0, stream>>>(
        (const uint32_t*)q, (const uint32_t*)c, nq, nc, W, k, cb,
        (int32_t*)matches, (int32_t*)both);
}

// Launches the (blk_q, blk_n) tile of STRADDLE_TILES; false if there is none.
static bool launch_straddle(int blk_q, int blk_n, bool sentinel,
                            const void* q, const void* c, int nq, int nc,
                            int W, int k, int cb, void* matches, void* both,
                            cudaStream_t stream) {
#define STRADDLE_CASE(TQ, TN)                                               \
  if (blk_q == TQ && blk_n == TN) {                                         \
    launch_straddle_tile<TQ, TN>(sentinel, q, c, nq, nc, W, k, cb, matches, \
                                 both, stream);                             \
    return true;                                                            \
  }
  STRADDLE_TILES(STRADDLE_CASE)
#undef STRADDLE_CASE
  return false;
}

// q (nq, W) and c (nc, W) packed words; matches (nq, nc) int32; both
// (nq, nc) int32 or null unless sentinel.  hi / lo are the per-field
// masks of zero_fields and last_mask the valid bits of word W-1; the
// wrapper computes them (repro_torch/kernels/hamming.py).  (blk_q, blk_n)
// is the output tile: one of SWAR_TILES when cb divides 32, else one of
// STRADDLE_TILES; any other returns cudaErrorInvalidValue, as does a
// sentinel wire of 1-bit codes or a code width outside [1, 32].
extern "C" int packed_match_tiled_launch(const void* q, const void* c, int nq,
                                         int nc, int W, int k, int cb,
                                         int sentinel, uint32_t hi,
                                         uint32_t lo, uint32_t last_mask,
                                         int blk_q, int blk_n, void* matches,
                                         void* both, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const bool sent = sentinel != 0;
  if (cb < 1 || cb > 32 || (cb == 1 && sent))
    return (int)cudaErrorInvalidValue;  // a sentinel needs code_bits >= 2
  bool ok;
  switch (cb) {
#define SWAR_CB(CB)                                                         \
    case CB:                                                                \
      ok = launch_swar<CB>(blk_q, blk_n, sent, q, c, nq, nc, W, hi, lo,     \
                           last_mask, matches, both, s);                    \
      break;
    SWAR_CB(1) SWAR_CB(2) SWAR_CB(4) SWAR_CB(8) SWAR_CB(16) SWAR_CB(32)
#undef SWAR_CB
    default:
      ok = launch_straddle(blk_q, blk_n, sent, q, c, nq, nc, W, k, cb,
                           matches, both, s);
  }
  return ok ? (int)cudaGetLastError() : (int)cudaErrorInvalidValue;
}

// The default tiles' case (the first of each list), with the C signature
// older checkouts' wrappers call.
extern "C" int packed_match_launch(const void* q, const void* c, int nq,
                                   int nc, int W, int k, int cb, int sentinel,
                                   uint32_t hi, uint32_t lo,
                                   uint32_t last_mask, void* matches,
                                   void* both, void* stream) {
  const bool swar = cb >= 1 && cb <= 32 && 32 % cb == 0;
  return packed_match_tiled_launch(q, c, nq, nc, W, k, cb, sentinel, hi, lo,
                                   last_mask, swar ? 64 : 32, 64, matches,
                                   both, stream);
}
