// Fq2 / Fq6 / Fq12 arithmetic and the Miller doubling step of K4 and K5,
// for one thread: the formulas of ops/bls/tower.py and ops/bls/pairing.py
// on bls_fq.cuh's Fq, value for value.  Which sums are renormalized and
// which values are multiplied follows the torch code exactly, so the
// limbs a kernel writes are the plain version's.
//
// Layouts (as the torch code's, w-power basis for Fq12):
//   Fq2  = c0 + c1*u, u^2 = -1
//   Fq6  = c0 + c1*v + c2*v^2 over Fq2, v^3 = xi = 1 + u
//   Fq12 = sum_k w[k] * w^k, k = 0..5, w^6 = xi
#pragma once

#include "bls_fq.cuh"

namespace bls {

struct Fq2 {
  Fq c0, c1;
};

struct Fq6 {
  Fq2 c[3];
};

struct Fq12 {
  Fq2 w[6];
};

// Fq2 ------------------------------------------------------------------------

__device__ __forceinline__ Fq2 f2_add(const Fq2& a, const Fq2& b) {
  return {fq_add(a.c0, b.c0), fq_add(a.c1, b.c1)};
}

__device__ __forceinline__ Fq2 f2_sub(const Fq2& a, const Fq2& b) {
  return {fq_sub(a.c0, b.c0), fq_sub(a.c1, b.c1)};
}

__device__ __forceinline__ Fq2 f2_neg(const Fq2& a) {
  return {fq_neg(a.c0), fq_neg(a.c1)};
}

__device__ __forceinline__ Fq2 f2_smul(long long k, const Fq2& a) {
  return {fq_smul(k, a.c0), fq_smul(k, a.c1)};
}

// times xi = 1 + u: (c0 - c1, c0 + c1)
__device__ __forceinline__ Fq2 f2_xi(const Fq2& a) {
  return {fq_sub(a.c0, a.c1), fq_add(a.c0, a.c1)};
}

__device__ __forceinline__ Fq2 f2_renorm(const Fq2& a) {
  return {fq_renorm(a.c0), fq_renorm(a.c1)};
}

// tower.fq2_mul: Karatsuba, renormed
__device__ __noinline__ Fq2 f2_mul(const Fq2& a, const Fq2& b) {
  const Fq t0 = fq_mul(a.c0, b.c0);
  const Fq t1 = fq_mul(a.c1, b.c1);
  const Fq t2 = fq_mul(fq_add(a.c0, a.c1), fq_add(b.c0, b.c1));
  return f2_renorm({fq_sub(t0, t1), fq_sub(fq_sub(t2, t0), t1)});
}

// tower.fq2_square: (a0+a1)(a0-a1) and 2*a0*a1, renormed
__device__ __noinline__ Fq2 f2_sq(const Fq2& a) {
  const Fq t0 = fq_mul(fq_add(a.c0, a.c1), fq_sub(a.c0, a.c1));
  const Fq t1 = fq_mul(a.c0, a.c1);
  return f2_renorm({t0, fq_smul(2, t1)});
}

// pairing._scale: an Fq2 times an Fq scalar, not renormed
__device__ __forceinline__ Fq2 f2_scale(const Fq2& a, const Fq& s) {
  return {fq_mul(a.c0, s), fq_mul(a.c1, s)};
}

// Fq6 ------------------------------------------------------------------------

__device__ __forceinline__ Fq6 f6_add(const Fq6& a, const Fq6& b) {
  return {{f2_add(a.c[0], b.c[0]), f2_add(a.c[1], b.c[1]),
           f2_add(a.c[2], b.c[2])}};
}

__device__ __forceinline__ Fq6 f6_renorm(const Fq6& a) {
  return {{f2_renorm(a.c[0]), f2_renorm(a.c[1]), f2_renorm(a.c[2])}};
}

// tower.fq6_mul_by_v: (xi*a2, a0, a1)
__device__ __forceinline__ Fq6 f6_mul_by_v(const Fq6& a) {
  return {{f2_xi(a.c[2]), a.c[0], a.c[1]}};
}

// tower.fq6_mul: 6 Fq2 products, renormed
__device__ __noinline__ Fq6 f6_mul(const Fq6& a, const Fq6& b) {
  const Fq2 t0 = f2_mul(a.c[0], b.c[0]);
  const Fq2 t1 = f2_mul(a.c[1], b.c[1]);
  const Fq2 t2 = f2_mul(a.c[2], b.c[2]);
  const Fq2 m12 = f2_mul(f2_add(a.c[1], a.c[2]), f2_add(b.c[1], b.c[2]));
  const Fq2 m01 = f2_mul(f2_add(a.c[0], a.c[1]), f2_add(b.c[0], b.c[1]));
  const Fq2 m02 = f2_mul(f2_add(a.c[0], a.c[2]), f2_add(b.c[0], b.c[2]));
  Fq6 r;
  r.c[0] = f2_renorm(f2_add(f2_xi(f2_sub(f2_sub(m12, t1), t2)), t0));
  r.c[1] = f2_renorm(f2_add(f2_sub(f2_sub(m01, t0), t1), f2_xi(t2)));
  r.c[2] = f2_renorm(f2_add(f2_sub(f2_sub(m02, t0), t2), t1));
  return r;
}

// Fq12 -----------------------------------------------------------------------

// tower.fq12_square: the tower split, 2 Fq6 products
__device__ __noinline__ Fq12 f12_square(const Fq12& a) {
  const Fq6 c0 = {{a.w[0], a.w[2], a.w[4]}};
  const Fq6 c1 = {{a.w[1], a.w[3], a.w[5]}};
  const Fq6 t0 = f6_mul(c0, c1);
  const Fq6 m = f6_mul(f6_renorm(f6_add(c0, c1)),
                       f6_renorm(f6_add(c0, f6_mul_by_v(c1))));
  const Fq6 tv = f6_mul_by_v(t0);
  Fq12 r;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    r.w[2 * k] = f2_renorm(f2_sub(f2_sub(m.c[k], t0.c[k]), tv.c[k]));
    r.w[2 * k + 1] = f2_renorm(f2_add(t0.c[k], t0.c[k]));
  }
  return r;
}

// tower.fq12_mul_line: f times the sparse line l0 + l3*w^3 + l5*w^5, 18 Fq2
// products, folding w^6 = xi
__device__ __noinline__ Fq12 f12_mul_line(const Fq12& f, const Fq2& l0,
                                          const Fq2& l3, const Fq2& l5) {
  Fq2 acc[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) acc[i] = f2_mul(f.w[i], l0);  // slot i
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    const Fq2 t3 = f2_mul(f.w[i], l3);                       // slot i + 3
    acc[(i + 3) % 6] = f2_add(acc[(i + 3) % 6], i + 3 >= 6 ? f2_xi(t3) : t3);
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    const Fq2 t5 = f2_mul(f.w[i], l5);                       // slot i + 5
    acc[(i + 5) % 6] = f2_add(acc[(i + 5) % 6], i + 5 >= 6 ? f2_xi(t5) : t5);
  }
  Fq12 r;
#pragma unroll
  for (int k = 0; k < 6; ++k) r.w[k] = f2_renorm(acc[k]);
  return r;
}

// the Miller doubling step (pairing._dbl_step) -------------------------------

struct Line {
  Fq2 l0, l3, l5;
};

// T <- 2T on the twist, in place, and the scaled tangent line at P
__device__ __noinline__ Line dbl_step(Fq2& X, Fq2& Y, Fq2& Z, const Fq& px,
                                      const Fq& py) {
  const Fq2 XX = f2_sq(X);
  const Fq2 YY = f2_sq(Y);
  const Fq2 S = f2_mul(Y, Z);
  const Fq2 W = f2_add(f2_add(XX, XX), XX);                   // 3X^2
  const Fq2 B = f2_mul(f2_mul(X, Y), S);                      // XYS
  const Fq2 H = f2_renorm(f2_sub(f2_sq(W), f2_smul(8, B)));  // W^2 - 8B
  const Fq2 SS = f2_sq(S);
  const Fq2 X3 = f2_renorm(f2_smul(2, f2_mul(H, S)));
  const Fq2 Y3 = f2_renorm(
      f2_sub(f2_mul(W, f2_renorm(f2_sub(f2_smul(4, B), H))),
             f2_smul(8, f2_sq(f2_mul(Y, S)))));
  const Fq2 Z3 = f2_renorm(f2_smul(8, f2_mul(SS, S)));
  const Fq2 beta = f2_smul(2, f2_mul(S, Z));                 // 2YZ^2
  Line line;
  line.l0 = f2_neg(f2_scale(f2_xi(beta), py));
  line.l3 = f2_renorm(
      f2_sub(f2_smul(2, f2_mul(YY, Z)), f2_smul(3, f2_mul(XX, X))));
  line.l5 = f2_scale(f2_renorm(f2_smul(3, f2_mul(XX, Z))), px);
  X = X3;
  Y = Y3;
  Z = Z3;
  return line;
}

// loads and stores of the torch layouts ---------------------------------------

__device__ __forceinline__ void load_fq(Fq& a, const long long* src) {
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) a.l[i] = src[i];
}

__device__ __forceinline__ void store_fq(long long* dst, const Fq& a) {
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) dst[i] = a.l[i];
}

// [2, 16]
__device__ __forceinline__ void load_fq2(Fq2& a, const long long* src) {
  load_fq(a.c0, src);
  load_fq(a.c1, src + kLimbs);
}

__device__ __forceinline__ void store_fq2(long long* dst, const Fq2& a) {
  store_fq(dst, a.c0);
  store_fq(dst + kLimbs, a.c1);
}

// [6, 2, 16]
__device__ __forceinline__ void load_fq12(Fq12& a, const long long* src) {
#pragma unroll
  for (int k = 0; k < 6; ++k) load_fq2(a.w[k], src + 2 * kLimbs * k);
}

__device__ __forceinline__ void store_fq12(long long* dst, const Fq12& a) {
#pragma unroll
  for (int k = 0; k < 6; ++k) store_fq2(dst + 2 * kLimbs * k, a.w[k]);
}

}  // namespace bls
