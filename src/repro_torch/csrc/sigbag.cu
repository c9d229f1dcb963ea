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
// A row shard (sigbag_shard_launch): the table holds rows [row0, row0 +
// two_b) of the whole table's 2^b axis, and a token t adds local row
// t - row0 when it lies in that range, nothing otherwise -- one unsigned
// subtraction before the range compare below, (uint32)t - (uint32)row0 <
// (uint32)two_b, exact for every int32 token and 0 <= row0 <= 2^31 - 1 -
// two_b.  The sum of every shard's bag is the whole table's bag.  Both
// designs plan from the local two_b, so a shard's smaller slot slices may
// stage where the whole table's would not.  sigbag_launch is row0 = 0.
//
// Result, bit for bit: each output element is a float32 sum that starts
// at +0 and adds slot j's value in the order j = 0, 1, ..., k-1 with plain
// round-to-nearest adds (__fadd_rn, never contracted), cast once at the
// end to the table's type -- what the Pallas kernel computes.  A token
// outside [0, two_b) adds nothing (its one-hot row is all zero there).
// Both designs below add +0 for such a token instead: the sum starts at +0
// and a round-to-nearest add gives -0 only from -0 + -0, so it never holds
// -0 and adding +0 leaves it as it is.  The order rules out a tensor-core
// one-hot product (tf32/bf16 rounding, and the MMA's own add order),
// splitting the slot axis across warps or blocks and combining partial
// sums, and atomics: every output element is summed by one thread, slots
// in order.
//
// Bound: bytes -- tokens read once, the table read once, the output
// written once (0.0307 ms at 262,144 rows x 64 slots, 2^b = 256, d = 32,
// float32).  But the in-order sum reads one d-wide table row per (row,
// slot), n*k*d values (2.15 GB at that shape); the cheapest place to read
// them from is shared memory, at 128 B/clk/SM: 0.064 ms on an H100 at
// 1.98 GHz, about twice the byte bound, for any design that keeps the
// sequential float32 sums.
//
// Two designs, chosen per call by one rule (make_plan; its twin is
// repro_torch.kernels.sigbag.staged_plan, and sigbag_plan reports it):
//
//   (A) staged -- when a table row is 16 * TPR bytes with TPR in
//       {1, 2, 4, 8, 16, 32}, the table is 16-byte aligned, at least
//       two slot slices (2^b rows + a zero row, rounded to 128 bytes)
//       fit in the 227 KB of shared memory a block may have, beside two
//       token stages, and n gives at least one block of R rows per SM.
//   (B) direct gather -- every other shape: request batches (n too small
//       to give every SM a staged block), a slot slice too large for two
//       stages (2^b * d large), rows that are no whole number of 16-byte
//       pieces (d = 1, the paper's linear-model inner product; odd d), or
//       a misaligned table.
//
// (A) A block owns R rows (R = min(1024, 32768 / d): 128 float32 sums a
// consumer thread) and all d columns.  A table-producer warp streams the
// slot slices table[j] (2^b x d, contiguous) into a ring of shared-memory
// stages, one bulk copy (TMA, cp.async.bulk) a slot, tracked by mbarriers
// (full: the bytes arrived; empty: all consumer warps are done with it).
// A token-producer warp copies the block's tokens eight slots at a time
// (32 bytes a row) with cp.async into two token stages, each requested as
// soon as its buffer is free.  Eight consumer warps hold the sums in
// registers.  A thread owns two 16-byte pieces (4 float32 or 8 bfloat16
// columns each) of RT rows, q and q + TT of a row's 2 TT pieces; in each
// 128-bit shared load the TT threads of one row read pieces 0..TT-1 while
// the next row's read TT..2TT-1, so where a row is 128 bytes or more a
// quarter-warp reads 128 distinct bytes of bank space whatever the tokens
// are (d = 32 float32: two rows of four threads).  A step takes two slots: one 8-byte token load a row,
// four table loads, then the adds in slot order; it polls its barriers
// together.  A token outside [0, 2^b) is clamped to 2^b, a row of zeros
// kept behind each stage, so the loop has no branch.  The table is read
// from L2 once per block (2 MB x n / R: 512 MB at serve_bulk), the tokens
// once.  What paces it on an H100 is not the shared-memory bytes but the
// latency of the loads and barriers with one block of 10 warps an SM.
//
// (B) Blocks of one or two warps (two only when that still leaves a block
// for every SM); two columns a lane where d is even (one 8-byte float32 or
// 4-byte bfloat16 load), else one; L lanes to a row (the power of two >=
// d / 2, at most 32), so at d = 32 a warp serves two rows and 512 request
// rows spread over every SM.  Each lane loads 64 / L of its row's tokens
// (vector loads when aligned), the L lanes swap them by __shfl_sync, and
// each lane puts all 64 slots' loads in flight before it adds them in
// order.  The table (2 MB for the recsys frontend) stays in L2 between
// requests; staging it per block would cost more than the request reads.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// (A)
#define A_WARPS 8                        // consumer warps of a staged block
#define A_THREADS ((A_WARPS + 2) * 32)   // + two producer warps
#define A_ROWS_MAX 1024                  // rows of a staged block
#define A_ACC 128                        // float32 sums a consumer thread
#define A_TCH 8                          // slots a token stage (32 B a row)
#define A_SPS 2                          // slots a consumer step (1 or 2)
#define A_PPT 2                          // 16-byte pieces a consumer thread
                                         // (1 where a row is one piece)
#define A_SMEM_MAX 232448                // opt-in shared memory a block (227 KB)
#define A_MAX_STAGES 8
#define A_BARRIER_BYTES 256              // full[8], empty[8], tfull[2], tempty[2]
// (B)
#define B_SLOTS 64                       // slot loads in flight a lane

// ---------------------------------------------------------------------------
// Value types and a lane's load word

struct F32 {
  typedef float T;
};

struct BF16 {
  typedef unsigned short T;   // the bf16 bit pattern
  static __device__ __forceinline__ float lo(uint32_t w) {
    return __uint_as_float(w << 16);            // exact widening
  }
  static __device__ __forceinline__ float hi(uint32_t w) {
    return __uint_as_float(w & 0xFFFF0000u);
  }
  static __device__ __forceinline__ uint32_t round(float x) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(x));
  }
};

// LB bytes of consecutive columns, loaded as one word
template <int LB> struct Word;
template <> struct Word<2> { typedef unsigned short T; };
template <> struct Word<4> { typedef unsigned int T; };
template <> struct Word<8> { typedef uint2 T; };
template <> struct Word<16> { typedef uint4 T; };   // (A)'s pieces

template <int LB>
static __device__ __forceinline__ void unpack(typename Word<LB>::T w,
                                              uint32_t* u) {
  if constexpr (LB <= 4) {
    u[0] = w;
  } else if constexpr (LB == 8) {
    u[0] = w.x; u[1] = w.y;
  } else {
    u[0] = w.x; u[1] = w.y; u[2] = w.z; u[3] = w.w;
  }
}

template <int LB>
static __device__ __forceinline__ typename Word<LB>::T pack(const uint32_t* u) {
  if constexpr (LB == 2) return (unsigned short)u[0];
  else if constexpr (LB == 4) return u[0];
  else if constexpr (LB == 8) return make_uint2(u[0], u[1]);
  else return make_uint4(u[0], u[1], u[2], u[3]);
}

// acc[0 .. LB / sizeof(T)) += the word's columns, widened exactly
template <class D, int LB>
static __device__ __forceinline__ void add_word(float* acc,
                                                typename Word<LB>::T w) {
  uint32_t u[LB < 4 ? 1 : LB / 4];
  unpack<LB>(w, u);
  if constexpr (sizeof(typename D::T) == 4) {
#pragma unroll
    for (int m = 0; m < LB / 4; ++m)
      acc[m] = __fadd_rn(acc[m], __uint_as_float(u[m]));
  } else if constexpr (LB == 2) {
    acc[0] = __fadd_rn(acc[0], BF16::lo(u[0]));
  } else {
#pragma unroll
    for (int m = 0; m < LB / 4; ++m) {
      acc[2 * m] = __fadd_rn(acc[2 * m], BF16::lo(u[m]));
      acc[2 * m + 1] = __fadd_rn(acc[2 * m + 1], BF16::hi(u[m]));
    }
  }
}

// the sums as the table's type, rounded once
template <class D, int LB>
static __device__ __forceinline__ typename Word<LB>::T pack_word(
    const float* acc) {
  uint32_t u[LB < 4 ? 1 : LB / 4];
  if constexpr (sizeof(typename D::T) == 4) {
#pragma unroll
    for (int m = 0; m < LB / 4; ++m) u[m] = __float_as_uint(acc[m]);
  } else if constexpr (LB == 2) {
    u[0] = BF16::round(acc[0]);
  } else {
#pragma unroll
    for (int m = 0; m < LB / 4; ++m)
      u[m] = BF16::round(acc[2 * m]) | BF16::round(acc[2 * m + 1]) << 16;
  }
  return pack<LB>(u);
}

// ---------------------------------------------------------------------------
// (A) staged slot tables

// mbarrier and asynchronous-copy primitives (PTX, sm_90)
static __device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
static __device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}
// 1 once the phase of ``bar`` with this parity has completed
static __device__ __forceinline__ uint32_t mbar_done(uint32_t bar,
                                                     uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done;
}
static __device__ __forceinline__ void mbar_wait(uint32_t bar,
                                                 uint32_t parity) {
  while (!mbar_done(bar, parity)) {
  }
}
static __device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}
static __device__ __forceinline__ void mbar_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar), "r"(bytes) : "memory");
}
static __device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                                 uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
static __device__ __forceinline__ void cp_async16(uint32_t dst,
                                                  const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst),
               "l"(src) : "memory");
}
static __device__ __forceinline__ void cp_async4(uint32_t dst,
                                                 const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst),
               "l"(src) : "memory");
}
// arrives on ``bar`` when this thread's cp.asyncs so far have landed
static __device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   bar) : "memory");
}

// Token stage layout: row r's A_TCH slots at r * A_TROW bytes, two 16-byte
// pieces that swap places when bit 2 of r is set, so that the 8 rows of a
// warp-step read at once sit in distinct banks.
#define A_TROW (A_TCH * 4)
static __device__ __forceinline__ int tok_swz(int r) { return (r >> 2) & 1; }
static __device__ __forceinline__ int tok_off(int jj, int swz) {
  return (((jj >> 2) ^ swz) << 4) | ((jj & 3) << 2);
}

template <class D, int TPR>
struct Staged {
  static constexpr int V = 16 / sizeof(typename D::T);  // columns a piece
  static constexpr int PPT = TPR > 1 ? A_PPT : 1;  // pieces a thread
  static constexpr int TT = TPR / PPT;          // threads a row
  static constexpr int ACC = PPT * V;           // sums a row and thread
  static constexpr int RPW = 32 / TT;           // rows a warp-step
  static constexpr int STEP = A_WARPS * RPW;    // rows a block-step
  static constexpr int RT = (A_ACC / ACC < A_ROWS_MAX / STEP)
                                ? A_ACC / ACC : A_ROWS_MAX / STEP;
  static constexpr int R = STEP * RT;           // rows a block
};

// A consumer thread's view of the stage rings
struct Ring {
  int s;                    // the next slot's stage
  uint32_t ph;              // its full-barrier parity
  int stages, stage_bytes;
  int two_b, k;
  uint32_t row0;            // the shard's first row (0: the whole table)
  uint32_t full0, empty0, tfull0, tempty0;
  int lane;
  const unsigned char* tok;   // this thread's row of token stage 0
  int swz;
  const unsigned char* tab;   // this thread's first piece in slot stage 0
  int delta;                  // bytes from its first piece to its second
};

// Slots j .. j + P - 1, P = 1 or 2 (j % P == 0, so they share a token
// stage and a 16-byte half of each token row): one token load of P slots
// a row, P table loads a piece, then the adds in slot order.
template <class D, int TPR, int P>
static __device__ __forceinline__ void consume(
    float (&acc)[Staged<D, TPR>::RT][Staged<D, TPR>::ACC], int j, Ring& g) {
  typedef Staged<D, TPR> S;
  constexpr int ROWB = TPR * 16;
  const int jj = j % A_TCH, c = j / A_TCH, tb = c & 1;
  int st[P];
  uint32_t par[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    st[p] = g.s;
    par[p] = g.ph;
    if (++g.s == g.stages) { g.s = 0; g.ph ^= 1; }
  }
  // poll the step's barriers together: one round trip when all are done
  uint32_t done;
  do {
    done = jj ? 1u : mbar_done(g.tfull0 + 8 * tb, (c >> 1) & 1);
#pragma unroll
    for (int p = 0; p < P; ++p) done &= mbar_done(g.full0 + 8 * st[p], par[p]);
  } while (!done);
  const unsigned char* tk = g.tok + tb * S::R * A_TROW + tok_off(jj, g.swz);
  const unsigned char* tab[P];
#pragma unroll
  for (int p = 0; p < P; ++p) tab[p] = g.tab + st[p] * g.stage_bytes;
#pragma unroll
  for (int i = 0; i < S::RT; ++i) {
    const unsigned char* ti = tk + i * S::STEP * A_TROW;
    uint32_t t[P];
    if constexpr (P == 2) {
      const uint2 w = *reinterpret_cast<const uint2*>(ti);
      t[0] = w.x; t[1] = w.y;
    } else {
      t[0] = *reinterpret_cast<const uint32_t*>(ti);
    }
    uint4 w[P][S::PPT];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const uint32_t tl = t[p] - g.row0;       // the shard's row
      const uint32_t u = tl < (uint32_t)g.two_b ? tl : (uint32_t)g.two_b;
      const unsigned char* row = tab[p] + u * ROWB;   // else the zero row
#pragma unroll
      for (int m = 0; m < S::PPT; ++m)
        w[p][m] = *reinterpret_cast<const uint4*>(row + m * g.delta);
    }
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int m = 0; m < S::PPT; ++m)
        add_word<D, 16>(acc[i] + m * S::V, w[p][m]);
  }
  __syncwarp();
  if (g.lane == 0) {
#pragma unroll
    for (int p = 0; p < P; ++p) mbar_arrive(g.empty0 + 8 * st[p]);
    if (jj + P == A_TCH || j + P == g.k) mbar_arrive(g.tempty0 + 8 * tb);
  }
}

// Thread roles: warps 0 .. A_WARPS-1 consume, warp A_WARPS copies slot
// slices, warp A_WARPS + 1 copies tokens.  Consumer thread (warp w, lane =
// sub * TT + q) owns two pieces of rows r0 + (i * A_WARPS + w) * RPW +
// sub, i = 0..RT-1.
template <class D, int TPR>
__global__ void __launch_bounds__(A_THREADS, 1)
sigbag_staged(const int32_t* __restrict__ tokens,
              const typename D::T* __restrict__ table, int n, int k,
              int two_b, int row0, int stages, int stage_bytes, int vec,
              typename D::T* __restrict__ out) {
  typedef Staged<D, TPR> S;
  constexpr int ROWB = TPR * 16;                // bytes of a table row
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* toks = smem + A_BARRIER_BYTES;
  unsigned char* tabs = toks + 2 * S::R * A_TROW;
  const uint32_t full0 = smem_addr(smem);
  const uint32_t empty0 = full0 + 8 * A_MAX_STAGES;
  const uint32_t tfull0 = full0 + 16 * A_MAX_STAGES;
  const uint32_t tempty0 = tfull0 + 16;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = blockIdx.x * S::R;
  const int rows = min(S::R, n - r0);
  const uint32_t slice = (uint32_t)two_b * ROWB;  // bytes of table[j]

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, A_WARPS);
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(tfull0 + 8 * s, 32);
      mbar_init(tempty0 + 8 * s, A_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // the zero row behind each stage, for tokens outside [0, two_b)
  for (int x = threadIdx.x; x < stages * TPR; x += blockDim.x)
    *reinterpret_cast<uint4*>(tabs + (x / TPR) * stage_bytes + slice +
                              (x % TPR) * 16) = make_uint4(0, 0, 0, 0);
  __syncthreads();

  if (warp == A_WARPS) {
    // -- table producer: one bulk copy a slot, into the ring of stages
    if (lane == 0) {
      int s = 0;
      uint32_t ph = 1;                 // the first round finds stages empty
      for (int j = 0; j < k; ++j) {
        mbar_wait(empty0 + 8 * s, ph);
        mbar_expect_tx(full0 + 8 * s, slice);
        bulk_copy(smem_addr(tabs + s * stage_bytes),
                  reinterpret_cast<const unsigned char*>(table) +
                      (size_t)j * slice,
                  slice, full0 + 8 * s);
        if (++s == stages) { s = 0; ph ^= 1; }
      }
    }
    return;
  }
  if (warp == A_WARPS + 1) {
    // -- token producer: A_TCH slots of every row a chunk, two buffers
    for (int j = 0, c = 0; j < k; j += A_TCH, ++c) {
      const int tb = c & 1;
      if (lane == 0) mbar_wait(tempty0 + 8 * tb, ((c >> 1) & 1) ^ 1);
      __syncwarp();
      unsigned char* dst = toks + tb * S::R * A_TROW;
      const int left = min(A_TCH, k - j);
      const int32_t* src = tokens + (size_t)r0 * k + j;
      if (vec) {                       // k % 4 == 0, tokens 16-byte aligned
        for (int x = lane; x < rows * 2; x += 32) {
          const int r = x >> 1, p = x & 1;
          if (4 * p < left)
            cp_async16(smem_addr(dst + r * A_TROW + tok_off(4 * p, tok_swz(r))),
                       src + (size_t)r * k + 4 * p);
        }
      } else {
        for (int x = lane; x < rows * A_TCH; x += 32) {
          const int r = x / A_TCH, jj = x % A_TCH;
          if (jj < left)
            cp_async4(smem_addr(dst + r * A_TROW + tok_off(jj, tok_swz(r))),
                      src + (size_t)r * k + jj);
        }
      }
      cp_async_arrive(tfull0 + 8 * tb);
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
    return;
  }

  // -- consumers: A_SPS slots a step, then single slots for k's tail.
  // With two pieces a thread (q and q + TT), rows of odd sub take them in
  // the other order, so the two rows of a quarter-warp read distinct
  // banks in each load.
  const int sub = lane / S::TT, q = lane % S::TT;
  const int rl0 = warp * S::RPW + sub;           // block row of step 0
  const int swz = tok_swz(rl0);                  // the same for every step
  const int piece0 = S::PPT == 2 && (sub & 1) ? q + S::TT : q;
  const int piece1 = S::PPT == 2 && !(sub & 1) ? q + S::TT : q;
  float acc[S::RT][S::ACC];
#pragma unroll
  for (int i = 0; i < S::RT; ++i)
#pragma unroll
    for (int v = 0; v < S::ACC; ++v) acc[i][v] = 0.0f;
  Ring ring = {0, 0, stages, stage_bytes, two_b, k, (uint32_t)row0, full0,
               empty0, tfull0, tempty0, lane, toks + rl0 * A_TROW, swz,
               tabs + piece0 * 16, (piece1 - piece0) * 16};
  int j = 0;
  if (stages >= A_SPS)                           // a step's slots all staged
    for (; j + A_SPS <= k; j += A_SPS) consume<D, TPR, A_SPS>(acc, j, ring);
  for (; j < k; ++j) consume<D, TPR, 1>(acc, j, ring);
#pragma unroll
  for (int i = 0; i < S::RT; ++i) {
    const int r = rl0 + i * S::STEP;
    unsigned char* o = reinterpret_cast<unsigned char*>(out) +
                       (size_t)(r0 + r) * ROWB;
    if (r < rows) {
      *reinterpret_cast<uint4*>(o + piece0 * 16) = pack_word<D, 16>(acc[i]);
      if (S::PPT == 2)
        *reinterpret_cast<uint4*>(o + piece1 * 16) =
            pack_word<D, 16>(acc[i] + S::V);
    }
  }
}

// ---------------------------------------------------------------------------
// (B) direct gather

template <int NT>
static __device__ __forceinline__ void load_tokens(int32_t* tk,
                                                   const int32_t* p, int left,
                                                   bool vec) {
  if (vec && left >= NT) {
    if constexpr (NT % 4 == 0) {
#pragma unroll
      for (int u = 0; u < NT; u += 4) {
        const int4 w = __ldg(reinterpret_cast<const int4*>(p + u));
        tk[u] = w.x; tk[u + 1] = w.y; tk[u + 2] = w.z; tk[u + 3] = w.w;
      }
      return;
    } else if constexpr (NT == 2) {
      const int2 w = __ldg(reinterpret_cast<const int2*>(p));
      tk[0] = w.x; tk[1] = w.y;
      return;
    }
  }
#pragma unroll
  for (int u = 0; u < NT; ++u) tk[u] = u < left ? __ldg(p + u) : -1;
}

// Lane li of a row's L lanes holds tokens j0 + li * NT .. + NT - 1 and
// loads columns c0 + li * V .. + V - 1, LB bytes, for every slot of the
// batch.  vec: k % NT == 0 and the tokens aligned to 4 * min(NT, 4) bytes.
template <class D, int LB, int L>
__global__ void __launch_bounds__(64)
sigbag_direct(const int32_t* __restrict__ tokens,
              const typename D::T* __restrict__ table, int n, int k,
              int two_b, int row0, int d, int vec,
              typename D::T* __restrict__ out) {
  typedef typename Word<LB>::T W;
  constexpr int V = LB / sizeof(typename D::T);  // columns a lane
  constexpr int SB = B_SLOTS;                    // slots a batch
  constexpr int NT = SB / L;                     // tokens a lane
  const int lane = threadIdx.x & 31, li = lane & (L - 1);
  const int row = (blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5)) *
                      (32 / L) + lane / L;
  const bool live_row = row < n;
  const int32_t* tok = tokens + (size_t)(live_row ? row : 0) * k;
  for (int c0 = 0; c0 < d; c0 += L * V) {         // uniform across the warp
    const int c = c0 + li * V;
    const bool live = live_row && c < d;
    float acc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = 0.0f;
    for (int j0 = 0; j0 < k; j0 += SB) {
      const int first = j0 + li * NT;
      int32_t tk[NT];
      load_tokens<NT>(tk, tok + first, live_row ? k - first : 0, vec);
      W w[SB];
#pragma unroll
      for (int jj = 0; jj < SB; ++jj) {
        const int t = __shfl_sync(0xFFFFFFFFu, tk[jj % NT], jj / NT, L);
        // the shard's row; t = -1 past k (never in range: row0 + two_b
        // <= 2^31 - 1); the sum is never -0, so adding +0 leaves it
        const uint32_t tl = (uint32_t)t - (uint32_t)row0;
        w[jj] = (live && tl < (uint32_t)two_b)
                    ? __ldg(reinterpret_cast<const W*>(
                          table + ((size_t)(j0 + jj) * two_b + tl) * d + c))
                    : W{};
      }
#pragma unroll
      for (int jj = 0; jj < SB; ++jj) add_word<D, LB>(acc, w[jj]);
    }
    if (live)
      *reinterpret_cast<W*>(out + (size_t)row * d + c) = pack_word<D, LB>(acc);
  }
}

// ---------------------------------------------------------------------------
// Host side

struct Plan {
  int staged;        // 1: design A, 0: design B
  int rows;          // rows a block
  int stages;        // A: slot stages
  int stage_bytes;   // A: bytes a stage (slice + zero row, 128-aligned)
  int smem;          // A: dynamic shared memory
  int tpr;           // A: 16-byte pieces a row
  int sms;
};

static int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

// rows of a staged block: Staged<D, TPR>::R
static int staged_rows(int tpr, int bf16) {
  const int ppt = tpr > 1 ? A_PPT : 1, acc = ppt * (bf16 ? 8 : 4);
  const int step = A_WARPS * (32 / (tpr / ppt));
  const int rt = A_ACC / acc < A_ROWS_MAX / step ? A_ACC / acc
                                                 : A_ROWS_MAX / step;
  return step * rt;
}

static Plan make_plan(const void* table, int n, int two_b, int d, int bf16) {
  Plan p = {0, 0, 0, 0, 0, 0, sm_count()};
  const long long rowb = (long long)d * (bf16 ? 2 : 4);
  const long long tpr = rowb / 16;
  if (rowb % 16 || tpr < 1 || tpr > 32 || (tpr & (tpr - 1)) ||
      (uintptr_t)table % 16)
    return p;
  const long long sa = ((long long)two_b * rowb + rowb + 127) / 128 * 128;
  const int rows = staged_rows((int)tpr, bf16);
  const long long stages =
      (A_SMEM_MAX - A_BARRIER_BYTES - 2 * rows * A_TROW) / sa;
  if (stages < 2 || ((long long)n + rows - 1) / rows < p.sms) return p;
  p.staged = 1;
  p.tpr = (int)tpr;
  p.rows = rows;
  p.stages = stages < A_MAX_STAGES ? (int)stages : A_MAX_STAGES;
  p.stage_bytes = (int)sa;
  p.smem = A_BARRIER_BYTES + 2 * rows * A_TROW + p.stages * p.stage_bytes;
  return p;
}

template <class D, int TPR>
static int launch_staged(const Plan& p, const void* tokens, const void* table,
                         int n, int k, int two_b, int row0, void* out,
                         cudaStream_t st) {
  auto kern = sigbag_staged<D, TPR>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (e != cudaSuccess) return (int)e;
  const int vec = k % 4 == 0 && (uintptr_t)tokens % 16 == 0;
  kern<<<(n + p.rows - 1) / p.rows, A_THREADS, p.smem, st>>>(
      (const int32_t*)tokens, (const typename D::T*)table, n, k, two_b, row0,
      p.stages, p.stage_bytes, vec, (typename D::T*)out);
  return (int)cudaGetLastError();
}

template <class D>
static int dispatch_staged(const Plan& p, const void* tokens,
                           const void* table, int n, int k, int two_b,
                           int row0, void* out, cudaStream_t st) {
#define SIGBAG_STAGED(TPR) \
  launch_staged<D, TPR>(p, tokens, table, n, k, two_b, row0, out, st)
  switch (p.tpr) {
    case 1: return SIGBAG_STAGED(1);
    case 2: return SIGBAG_STAGED(2);
    case 4: return SIGBAG_STAGED(4);
    case 8: return SIGBAG_STAGED(8);
    case 16: return SIGBAG_STAGED(16);
    default: return SIGBAG_STAGED(32);
  }
#undef SIGBAG_STAGED
}

template <class D, int LB, int L>
static int launch_direct(int sms, const void* tokens, const void* table,
                         int n, int k, int two_b, int row0, int d, void* out,
                         cudaStream_t st) {
  constexpr int NT = B_SLOTS / L;
  const long long warps = ((long long)n + 32 / L - 1) / (32 / L);
  const int per_block = (warps + 1) / 2 >= sms ? 2 : 1;
  const long long grid = (warps + per_block - 1) / per_block;
  const int align = 4 * (NT < 4 ? NT : 4);
  const int vec = NT > 1 && k % NT == 0 && (uintptr_t)tokens % align == 0;
  sigbag_direct<D, LB, L><<<(unsigned)grid, 32 * per_block, 0, st>>>(
      (const int32_t*)tokens, (const typename D::T*)table, n, k, two_b, row0,
      d, vec, (typename D::T*)out);
  return (int)cudaGetLastError();
}

template <class D, int LB>
static int dispatch_direct(int sms, const void* tokens, const void* table,
                           int n, int k, int two_b, int row0, int d,
                           void* out, cudaStream_t st) {
  const int cols = (d + LB / (int)sizeof(typename D::T) - 1) /
                   (LB / (int)sizeof(typename D::T));
#define SIGBAG_DIRECT(L) \
  launch_direct<D, LB, L>(sms, tokens, table, n, k, two_b, row0, d, out, st)
  if (cols <= 1) return SIGBAG_DIRECT(1);
  if (cols <= 2) return SIGBAG_DIRECT(2);
  if (cols <= 4) return SIGBAG_DIRECT(4);
  if (cols <= 8) return SIGBAG_DIRECT(8);
  if (cols <= 16) return SIGBAG_DIRECT(16);
  return SIGBAG_DIRECT(32);
#undef SIGBAG_DIRECT
}

// Bytes a lane loads in design B: two columns where d is even and the
// table aligned to them, else one.
static int direct_bytes(const void* table, int d, int bf16) {
  const int lb = bf16 ? 4 : 8;
  return d % 2 == 0 && (uintptr_t)table % lb == 0 ? lb : lb / 2;
}

// The design a call takes: info = {1 staged (A) / 0 direct (B), rows a
// staged block, slot stages, bytes a stage, pieces a row, SMs}.
extern "C" int sigbag_plan(const void* table, int n, int two_b, int d,
                           int bf16, int* info) {
  const Plan p = make_plan(table, n, two_b, d, bf16);
  info[0] = p.staged;
  info[1] = p.rows;
  info[2] = p.stages;
  info[3] = p.stage_bytes;
  info[4] = p.tpr;
  info[5] = p.sms;
  return (int)cudaGetLastError();
}

// The bag over a row shard: ``table`` (k, rows, d) holds rows [row0, row0 +
// rows) of the whole table's 2^b axis (see the header).  bf16 != 0: table
// and out hold bfloat16, else float32.
extern "C" int sigbag_shard_launch(const void* tokens, const void* table,
                                   int n, int k, int rows, int row0, int d,
                                   int bf16, void* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (row0 < 0 || rows > 0x7FFFFFFF - row0) return (int)cudaErrorInvalidValue;
  const Plan p = make_plan(table, n, rows, d, bf16);
  if (p.staged)
    return bf16 ? dispatch_staged<BF16>(p, tokens, table, n, k, rows, row0,
                                        out, st)
                : dispatch_staged<F32>(p, tokens, table, n, k, rows, row0,
                                       out, st);
#define SIGBAG_DIRECT(D, LB) \
  dispatch_direct<D, LB>(p.sms, tokens, table, n, k, rows, row0, d, out, st)
  switch (direct_bytes(table, d, bf16) * (bf16 ? -1 : 1)) {
    case 8: return SIGBAG_DIRECT(F32, 8);
    case 4: return SIGBAG_DIRECT(F32, 4);
    case -4: return SIGBAG_DIRECT(BF16, 4);
    default: return SIGBAG_DIRECT(BF16, 2);
  }
#undef SIGBAG_DIRECT
}

// The whole table: the row shard at row0 = 0 (the port's wrapper calls
// sigbag_shard_launch; this entry keeps the C interface of checkouts
// from before the row-shard entry).
extern "C" int sigbag_launch(const void* tokens, const void* table, int n,
                             int k, int two_b, int d, int bf16, void* out,
                             void* stream) {
  return sigbag_shard_launch(tokens, table, n, k, two_b, 0, d, bf16, out,
                             stream);
}
