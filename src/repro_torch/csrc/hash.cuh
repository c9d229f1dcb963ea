// uint32 hash arithmetic shared by the signature kernels (sm_90a).
//
// Bit-equal to repro.core.hashing: the 2U multiply-shift wraps in
// uint32_t; the 4U Horner step forms acc * t + coef in a native 64-bit
// unsigned product (the TPU kernels emulate it with 16-bit limbs), then
// applies the paper's §3.4 BitMod on the (hi, lo) halves with the same
// uint32 wrap-arounds, so out-of-range inputs agree too.
#pragma once
#include <cstdint>

#define MERSENNE_P 0x7FFFFFFFu
#define SIG_EMPTY 0xFFFFFFFFu

__device__ __forceinline__ uint32_t hash2u(uint32_t t, uint32_t a1, uint32_t a2,
                                           int s, bool high) {
  uint32_t v = a1 + a2 * t;  // wraps mod 2^32 (Eq. 10)
  if (s >= 32) return v;
  return high ? (v >> (32 - s)) : (v & ((1u << s) - 1u));
}

__device__ __forceinline__ uint32_t bitmod_step(uint32_t acc, uint32_t t,
                                                uint32_t coef) {
  unsigned long long v = (unsigned long long)acc * t + coef;  // mod 2^64
  uint32_t hi = (uint32_t)(v >> 32), lo = (uint32_t)v;
  uint32_t v1 = ((hi << 1) | (lo >> 31)) + (lo & MERSENNE_P);  // fold 1
  uint32_t v2 = (v1 >> 31) + (v1 & MERSENNE_P);                 // fold 2
  return v2 >= MERSENNE_P ? v2 - MERSENNE_P : v2;               // v2 == p -> 0
}

__device__ __forceinline__ uint32_t hash4u(uint32_t t, uint32_t a0, uint32_t a1,
                                           uint32_t a2, uint32_t a3, int s) {
  uint32_t acc = a3;
  acc = bitmod_step(acc, t, a2);
  acc = bitmod_step(acc, t, a1);
  acc = bitmod_step(acc, t, a0);
  return s < 31 ? (acc & ((1u << s) - 1u)) : (acc % MERSENNE_P);
}

// The 4U polynomial as a sum of powers, a0 + a1*x1 + a2*x2 + a3*x3 with
// x1 = t, x2 = t^2 mod p and x3 = t^3 mod p staged once per nonzero, then
// reduced once to the canonical residue in [0, p).  Domain: every
// coefficient < p and t < 2^31, where this equals hash4u's Horner result
// before the s-bit mask (both are the canonical residue of the same
// polynomial).  Each product is < 2^62, so the sum is < 3*2^62 + 2^31 <
// 2^64; it can pass 2^63, so fold 1 keeps 64 bits (its result reaches 33
// bits) and fold 2 is then < 2^31 + 5, one conditional subtract from
// canonical.
__device__ __forceinline__ uint32_t powsum4u(uint32_t x1, uint32_t x2,
                                             uint32_t x3, uint32_t a0,
                                             uint32_t a1, uint32_t a2,
                                             uint32_t a3) {
  unsigned long long v = (unsigned long long)a1 * x1 + a0;
  v += (unsigned long long)a2 * x2;
  v += (unsigned long long)a3 * x3;
  v = (v & MERSENNE_P) + (v >> 31);                          // fold 1, < 2^33 + 1
  const uint32_t r = (uint32_t)(v & MERSENNE_P) + (uint32_t)(v >> 31);  // fold 2
  return min(r, r - MERSENNE_P);                             // r == p -> 0
}
