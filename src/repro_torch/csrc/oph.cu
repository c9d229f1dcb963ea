// One Permutation Hashing bin minima for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels oph2u_pallas / oph4u_pallas
// (src/repro/kernels/oph.py: _oph2u_kernel, _oph4u_kernel, _binned_min,
// _sentinel_codes).  The TPU version compares every (nonzero, bin) pair
// with a lane iota because a vector unit has no scatter; here each
// nonzero is hashed ONCE and scattered with a shared-memory atomicMin.
//
// Bound: device-memory bytes.  A row's indices are read once (4 bytes per
// nonzero) and its k bins written once; one hash and one shared atomic per
// nonzero are below the ALU and shared-memory rates.  What keeps such a
// kernel from the byte rate is latency: a thread that loads one 4-byte
// index, hashes and scatters it before it loads the next pays ~15
// device-memory latencies in turn for a 3,728-nonzero row, with 4 bytes
// in flight.  Design: one block per row; each thread first issues
// its VPT 16-byte loads of the row (a round covers VPT * 16 * blockDim.x
// bytes: the whole of a 3,728-nonzero row, 16 KB in flight a block), then
// fills the bins with EMPTY while they are in flight, and only then
// hashes and scatters them, one latency a row.  Rows longer than a round
// loop, each thread's next loads issued as soon as its last round is
// scattered.  2U runs 256 threads x 4 loads; 4U, whose Horner hash and
// scatter take ~40 SASS instructions a nonzero (ALU work that paces it
// beside the bytes), runs 128 threads x 8 loads, which gives each thread
// more independent hashes.  Persistent blocks that copy row r + 1 into
// shared memory by cp.async while binning row r were measured slower for
// both (see PERF.md).
//
// The row is split where it is aligned: a head of up to three lanes up to
// the first 16-byte boundary, a body of whole int4 words, a tail of up to
// three lanes; threads 0-2 take the head lanes and 3-5 the tail lanes with
// scalar loads.  So a row of any width and base address is read in
// 16-byte words where it can be, and no lane at or past counts[i] is read.
// The bins live in shared memory (k * 4 bytes) and are written out once,
// as sentinel (code_b + 1)-bit codes when code_b > 0 (EMPTY -> 2^code_b).
#include <cuda_runtime.h>
#include <cstdint>
#include "hash.cuh"

#define OPH_VPT 4  // 2U: 16-byte loads in flight per thread per round (4U: 8)

template <bool FOUR_U, int VPT>
__global__ void oph_kernel(const int32_t* __restrict__ idx,
                           const int32_t* __restrict__ counts, int nnz,
                           const uint32_t* __restrict__ ca,
                           const uint32_t* __restrict__ cb, int s,
                           int bin_bits, int high, int code_b,
                           uint32_t* __restrict__ out) {
  extern __shared__ uint32_t bins[];
  const int k = 1 << bin_bits;
  const int row = blockIdx.x, tid = threadIdx.x, bd = blockDim.x;

  int cnt = counts[row];
  cnt = cnt < 0 ? 0 : (cnt > nnz ? nnz : cnt);
  const int32_t* r = idx + (size_t)row * nnz;
  // head [0, head), body [head, tail) in int4 words, tail [tail, cnt)
  const int head =
      min(cnt, (int)(((16u - ((uint32_t)(uintptr_t)r & 15u)) & 15u) >> 2));
  const int nvec = (cnt - head) >> 2;
  const int tail = head + 4 * nvec;
  const int4* body = reinterpret_cast<const int4*>(r + head);

  int4 v[VPT];
#pragma unroll
  for (int u = 0; u < VPT; ++u) {
    const int q = u * bd + tid;
    v[u] = q < nvec ? __ldg(body + q) : make_int4(0, 0, 0, 0);
  }
  const int lane = tid < 3 ? tid : tail + tid - 3;
  const bool scalar = tid < 3 ? tid < head : (tid < 6 && lane < cnt);
  const uint32_t xs = scalar ? (uint32_t)__ldg(r + lane) : 0u;

  const int off_bits = s - bin_bits;
  const uint32_t off_mask = (off_bits >= 32) ? 0xFFFFFFFFu : ((1u << off_bits) - 1u);
  // 2U: ca = a1, cb = a2; 4U: ca = a[0..3] (Horner coefficients)
  uint32_t c0 = ca[0], c1 = FOUR_U ? ca[1] : cb[0], c2 = 0, c3 = 0;
  if (FOUR_U) { c2 = ca[2]; c3 = ca[3]; }
  auto scatter = [&](uint32_t x) {
    const uint32_t h = FOUR_U ? hash4u(x, c0, c1, c2, c3, s) : hash2u(x, c0, c1, s, high);
    const uint32_t bin = bin_bits > 0 ? (h >> off_bits) : 0u;
    atomicMin(&bins[bin], h & off_mask);
  };

  for (int j = tid; j < k; j += bd) bins[j] = SIG_EMPTY;  // loads in flight
  __syncthreads();

  if (scalar) scatter(xs);
  for (int base = 0;;) {
#pragma unroll
    for (int u = 0; u < VPT; ++u) {
      if (base + u * bd + tid < nvec) {
        scatter((uint32_t)v[u].x);
        scatter((uint32_t)v[u].y);
        scatter((uint32_t)v[u].z);
        scatter((uint32_t)v[u].w);
      }
    }
    base += VPT * bd;
    if (base >= nvec) break;
#pragma unroll
    for (int u = 0; u < VPT; ++u) {
      const int q = base + u * bd + tid;
      if (q < nvec) v[u] = __ldg(body + q);
    }
  }
  __syncthreads();

  uint32_t* o = out + (size_t)row * k;
  for (int j = tid; j < k; j += bd) {
    uint32_t w = bins[j];
    if (code_b > 0) w = (w == SIG_EMPTY) ? (1u << code_b) : (w & ((1u << code_b) - 1u));
    o[j] = w;
  }
}

// threads: the block size of 2U, a multiple of 64 (cudaErrorInvalidValue
// otherwise); 4U runs threads / 2 threads with 2 * OPH_VPT loads each (the
// same bytes in flight), still a whole number of warps and more than the
// six that take the scalar head and tail.
template <bool FOUR_U>
static int launch(const void* idx, const void* counts, int n, int nnz,
                  const void* ca, const void* cb, int s, int bin_bits, int high, int code_b,
                  void* out, int threads, void* stream) {
  if (threads < 64 || threads % 64 != 0) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(uint32_t) << bin_bits;
  const int bd = FOUR_U ? threads / 2 : threads;
  oph_kernel<FOUR_U, FOUR_U ? 2 * OPH_VPT : OPH_VPT>
      <<<n, bd, smem, (cudaStream_t)stream>>>(
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
