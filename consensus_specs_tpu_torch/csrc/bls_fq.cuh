// The BLS12-381 base-field (Fq) arithmetic of K3, K4 and K5, for one thread:
// the Montgomery product and the renorm.
//
// The representation is ops/bls/limbs.py's: an element is 16 signed 64-bit
// limbs of 26 bits, value = sum(l[i] << 26*i), in Montgomery form at
// R = 2^416.  Additions, subtractions and small multiples are lazy (one
// limb-wise op, nothing propagates); only the product reduces.  Every function
// here computes the same integer values as its torch counterpart in
// limbs.py, and every output there depends only on those values, so the
// limbs that leave a kernel are the plain version's, bit for bit.
//
// The product's operand envelope is limbs.mul's: limbs |a_i| <= 2^29, products
// |a*b| < R*p.  So each limb fits a signed 32-bit register, and each
// partial product a_i * b_j is a 32 x 32 -> 64-bit multiply-add into a
// 64-bit column sum; the sums stay below 2^63 (the audit in limbs.py).
// The REDC step's m * p_j products are 26 x 26 bits.  A product is 256
// such multiplies for the schoolbook and 240 for REDC (p's top limb is
// 0), all of them independent within a step, so one thread keeps the FMA
// pipe busy without shared memory.
#pragma once

#include <stdint.h>

namespace bls {

constexpr int kLimbs = 16;
constexpr int kLimbBits = 26;
constexpr long long kMask = (1LL << kLimbBits) - 1;
// -p^-1 mod 2^26
constexpr uint32_t kN0Inv = 66912253u;

// p's limbs, as a switch that folds to an immediate in unrolled code
__device__ __forceinline__ long long p_limb(int j) {
  switch (j) {
    case 0: return 67087019;
    case 1: return 62914559;
    case 2: return 67107743;
    case 3: return 66766159;
    case 4: return 2010111;
    case 5: return 28065161;
    case 6: return 51194383;
    case 7: return 4914588;
    case 8: return 59044741;
    case 9: return 31006162;
    case 10: return 3455693;
    case 11: return 7249625;
    case 12: return 65444427;
    case 13: return 8031839;
    case 14: return 106513;
    default: return 0;
  }
}

// a*b*R^-1 mod p, as limbs.mul_plain, of operands given as the signed
// 32-bit words of their limbs: canonical 26-bit digits, value in (0, 3p)
__device__ __forceinline__ void fq_mul_words(long long* out, const int32_t* ai,
                                             const int32_t* bi) {
  long long t[2 * kLimbs];
#pragma unroll
  for (int k = 0; k < 2 * kLimbs; ++k) t[k] = 0;
  // schoolbook: 256 signed 32 x 32 -> 64 multiply-adds
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) {
#pragma unroll
    for (int j = 0; j < kLimbs; ++j) t[i + j] += (long long)ai[i] * bi[j];
  }
  // REDC: clear limbs 0..15, one limb a step.  The low 26 bits of
  // m = t_i * (-p^-1) need only the low 32 bits of t_i.
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) {
    const uint32_t m = ((uint32_t)t[i] * kN0Inv) & (uint32_t)kMask;
#pragma unroll
    for (int j = 0; j < kLimbs; ++j) {
      if (p_limb(j) != 0)
        t[i + j] += (long long)((uint64_t)m * (uint64_t)p_limb(j));
    }
    t[i + 1] += t[i] >> kLimbBits;  // arithmetic: t_i = 0 mod 2^26
  }
  // + p, then carry to canonical digits (the last carry is 0)
  long long c = 0;
#pragma unroll
  for (int j = 0; j < kLimbs; ++j) {
    const long long v = t[kLimbs + j] + p_limb(j) + c;
    out[j] = v & kMask;
    c = v >> kLimbBits;
  }
}

// fq_mul_words of int64 limbs.  out may alias a or b.
__device__ __forceinline__ void fq_mul_body(long long* out, const long long* a,
                                            const long long* b) {
  int32_t ai[kLimbs], bi[kLimbs];
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) {
    ai[i] = (int32_t)a[i];
    bi[i] = (int32_t)b[i];
  }
  fq_mul_words(out, ai, bi);
}

// limbs.renorm, in place: signed carries, value unchanged; limbs 0..14
// canonical, the top limb absorbs the rest
__device__ __forceinline__ void fq_renorm(long long* a) {
  long long c = 0;
#pragma unroll
  for (int i = 0; i < kLimbs - 1; ++i) {
    const long long v = a[i] + c;
    a[i] = v & kMask;
    c = v >> kLimbBits;
  }
  a[kLimbs - 1] += c;
}

}  // namespace bls
