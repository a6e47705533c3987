// BLS12-381 device arithmetic for the RLC batch-verify kernels (K7-K10).
//
// Replaces, on the device, the limb arithmetic of the JAX package's
// `ops/bls_batch/fq.py` (fq_mul, fq_carry, fq_canon, fq_pow_const,
// fq_inv), `ops/bls_batch/tower.py` (the Fq2/Fq6/Fq12 tower) and
// `ops/bls_batch/curve_jax.py` (Jacobian pt_double / pt_add).
//
// Representation: `mont.cuh`'s core at 12 x 32-bit words, R = 2^384.
// The TPU layout (33 signed 12-bit limbs in int32, R = 2^396, lazy) was
// shaped by a machine without 64-bit multiplies; here a 32x32->64
// multiply-add is one instruction pair.  `load_fp` accepts the port's
// lazy limbs and `store_fp` writes canonical limbs, equal to `fq_canon`
// of the plain result.
//
// Constants (p, -p^-1 mod 2^32, the conversion factors, the Frobenius
// gammas, the untwist slot scales, |x| and the sliding-window digits of
// p - 2) are not typed in here: the wrapper computes them from the port's
// Python oracle and fills the `__constant__` block once through
// `bls_set_constants`.
//
// What bounds it: 32-bit integer multiply-add issue (an Fp product is
// 2 x 144 32x32->64 multiply-adds).
#pragma once

#include "mont.cuh"

#define BLS_NW 12       // 32-bit words of an Fp
#define BLS_NL MONT_NL  // 12-bit limbs of the boundary format
#define FP_INV_DIGITS 384   // sliding-window digits of p - 2 (381 at most)
#define FP_WINDOW_TABLE 16  // odd powers a, a^3, ..., a^31 of a window chain

struct FpField {
  static constexpr int NW = BLS_NW;
  __device__ __forceinline__ static const MontConsts<BLS_NW>& k();
};
using Fp = Mont<FpField>;
struct Fp2 { Fp c0, c1; };
struct Fp6 { Fp2 c0, c1, c2; };
struct Fp12 { Fp6 c0, c1; };
template <class F> struct Jac { F x, y, z; };

struct BlsConstants {
  MontConsts<BLS_NW> f;     // p, p - 2, the Montgomery one, the conversions
  uint32_t jx, jy;          // w-power slots of a line's x and y terms
  uint32_t x_abs_hi, x_abs_lo;  // |x|, the BLS12-381 parameter
  Fp2 gamma[6];             // Frobenius scale of w^i (Montgomery form)
  Fp2 sx, sy;               // untwist slot scales (Montgomery form)
  int8_t e_inv[FP_INV_DIGITS];  // p - 2: sliding-window digits, MSB first,
  uint32_t e_inv_len;           // each 0 or odd and < 2 FP_WINDOW_TABLE
};
static_assert(sizeof(BlsConstants) == 378 * 4, "constant block layout");

__constant__ BlsConstants BLS;

__device__ __forceinline__ const MontConsts<BLS_NW>& FpField::k() {
  return BLS.f;
}

// |x|, the BLS12-381 parameter, and the index of its top bit: the Miller
// loop and the final exponentiation's powers run over the bits below it,
// MSB first
__device__ __forceinline__ uint64_t bls_x_abs() {
  return ((uint64_t)BLS.x_abs_hi << 32) | BLS.x_abs_lo;
}
__device__ __forceinline__ int bls_x_top() {
  const uint64_t x_abs = bls_x_abs();
  int top = 63;
  while (!((x_abs >> top) & 1)) --top;
  return top;
}

// --- Fp: mont.cuh's core at 12 words ---------------------------------------

__device__ __forceinline__ void fp_zero(Fp& r) { mont_zero(r); }
__device__ __forceinline__ void fp_one(Fp& r) { mont_one(r); }
__device__ __forceinline__ void fp_from_const(Fp& r, const uint32_t* c) {
  mont_from_const(r, c);
}
__device__ __forceinline__ bool fp_is_zero(const Fp& a) {
  return mont_is_zero(a);
}
__device__ __forceinline__ bool fp_eq(const Fp& a, const Fp& b) {
  return mont_eq(a, b);
}
__device__ __forceinline__ void fp_mul(Fp& r, const Fp& a, const Fp& b) {
  mont_mul(r, a, b);
}
__device__ __forceinline__ void fp_sqr(Fp& r, const Fp& a) { fp_mul(r, a, a); }
__device__ __forceinline__ void fp_add(Fp& r, const Fp& a, const Fp& b) {
  mont_add(r, a, b);
}
__device__ __forceinline__ void fp_sub(Fp& r, const Fp& a, const Fp& b) {
  mont_sub(r, a, b);
}
__device__ __forceinline__ void fp_neg(Fp& r, const Fp& a) {
  Fp z;
  fp_zero(z);
  fp_sub(r, z, a);
}
__device__ __forceinline__ void fp_dbl(Fp& r, const Fp& a) { fp_add(r, a, a); }
__device__ __forceinline__ void fp_triple(Fp& r, const Fp& a) {
  Fp t;
  fp_add(t, a, a);
  fp_add(r, t, a);
}
// a^(p-2): Fermat inversion, 0 -> 0
__device__ __forceinline__ void fp_inv(Fp& r, const Fp& a) { mont_inv(r, a); }
// the same inverse by mont.cuh's binary inversion (768 branch-free steps)
__device__ __forceinline__ void fp_inv_binary(Fp& r, const Fp& a) {
  mont_inv_binary(r, a);
}

// a^e for e given by its sliding-window digits d (MSB first, each 0 or an
// odd value < 2 FP_WINDOW_TABLE): a square per digit after the first
// nonzero one, a product per nonzero digit.  a = 0 gives 0.
__device__ __noinline__ void fp_pow_window(Fp& out, const Fp& a,
                                           const int8_t* d, int len) {
  Fp tab[FP_WINDOW_TABLE], a2, acc;
  tab[0] = a;
  fp_sqr(a2, a);
  for (int k = 1; k < FP_WINDOW_TABLE; ++k) fp_mul(tab[k], tab[k - 1], a2);
  int k = 0;
  while (!d[k]) ++k;
  acc = tab[d[k] >> 1];
  for (++k; k < len; ++k) {
    fp_sqr(acc, acc);
    if (d[k]) fp_mul(acc, acc, tab[d[k] >> 1]);
  }
  out = acc;
}
// (33,) int32 limbs, value x 2^396 (lazy) -> x 2^384
__device__ __forceinline__ void load_fp(Fp& r, const int32_t* src) {
  mont_load(r, src);
}
// x 2^384 -> canonical limbs of x 2^396 mod p
__device__ __forceinline__ void store_fp(int32_t* dst, const Fp& a) {
  mont_store(dst, a);
}

// --- Fp2 = Fp[u] / (u^2 + 1) ---------------------------------------------

__device__ __forceinline__ void fp2_add(Fp2& r, const Fp2& a, const Fp2& b) {
  fp_add(r.c0, a.c0, b.c0);
  fp_add(r.c1, a.c1, b.c1);
}
__device__ __forceinline__ void fp2_sub(Fp2& r, const Fp2& a, const Fp2& b) {
  fp_sub(r.c0, a.c0, b.c0);
  fp_sub(r.c1, a.c1, b.c1);
}
__device__ __forceinline__ void fp2_neg(Fp2& r, const Fp2& a) {
  fp_neg(r.c0, a.c0);
  fp_neg(r.c1, a.c1);
}
__device__ __forceinline__ void fp2_dbl(Fp2& r, const Fp2& a) {
  fp2_add(r, a, a);
}
__device__ __forceinline__ void fp2_triple(Fp2& r, const Fp2& a) {
  Fp2 t;
  fp2_add(t, a, a);
  fp2_add(r, t, a);
}
__device__ __forceinline__ void fp2_conj(Fp2& r, const Fp2& a) {
  r.c0 = a.c0;
  fp_neg(r.c1, a.c1);
}
__device__ __forceinline__ void fp2_zero(Fp2& r) {
  fp_zero(r.c0);
  fp_zero(r.c1);
}
__device__ __forceinline__ void fp2_one(Fp2& r) {
  fp_one(r.c0);
  fp_zero(r.c1);
}
__device__ __forceinline__ bool fp2_is_zero(const Fp2& a) {
  return fp_is_zero(a.c0) && fp_is_zero(a.c1);
}
// * (1 + u)
__device__ __forceinline__ void fp2_mul_xi(Fp2& r, const Fp2& a) {
  Fp t0, t1;
  fp_sub(t0, a.c0, a.c1);
  fp_add(t1, a.c0, a.c1);
  r.c0 = t0;
  r.c1 = t1;
}

__device__ __noinline__ void fp2_mul(Fp2& r, const Fp2& a, const Fp2& b) {
  Fp t0, t1, s0, s1;
  fp_mul(t0, a.c0, b.c0);
  fp_mul(t1, a.c1, b.c1);
  fp_add(s0, a.c0, a.c1);
  fp_add(s1, b.c0, b.c1);
  fp_mul(s0, s0, s1);
  fp_sub(r.c0, t0, t1);
  fp_add(t0, t0, t1);
  fp_sub(r.c1, s0, t0);
}

__device__ __noinline__ void fp2_sqr(Fp2& r, const Fp2& a) {
  Fp s, d, m;
  fp_add(s, a.c0, a.c1);
  fp_sub(d, a.c0, a.c1);
  fp_mul(m, a.c0, a.c1);
  fp_mul(r.c0, s, d);
  fp_dbl(r.c1, m);
}

__device__ __forceinline__ void fp2_mul_fp(Fp2& r, const Fp2& a,
                                           const Fp& s) {
  fp_mul(r.c0, a.c0, s);
  fp_mul(r.c1, a.c1, s);
}

__device__ __noinline__ void fp2_inv(Fp2& r, const Fp2& a) {
  Fp n, t, d;
  fp_sqr(n, a.c0);
  fp_sqr(t, a.c1);
  fp_add(n, n, t);
  fp_inv(d, n);
  fp_mul(t, a.c1, d);
  fp_mul(r.c0, a.c0, d);
  fp_neg(r.c1, t);
}

// fp2_inv's formula with the Fp inversion a sliding-window chain over the
// digits (d, len) of p - 2; 0 -> 0
__device__ __noinline__ void fp2_inv_window(Fp2& r, const Fp2& a,
                                            const int8_t* d, int len) {
  Fp n, t, i;
  fp_sqr(n, a.c0);
  fp_sqr(t, a.c1);
  fp_add(n, n, t);
  fp_pow_window(i, n, d, len);
  fp_mul(t, a.c1, i);
  fp_mul(r.c0, a.c0, i);
  fp_neg(r.c1, t);
}

// --- Fp6 = Fp2[v] / (v^3 - xi) -------------------------------------------

__device__ __forceinline__ void fp6_add(Fp6& r, const Fp6& a, const Fp6& b) {
  fp2_add(r.c0, a.c0, b.c0);
  fp2_add(r.c1, a.c1, b.c1);
  fp2_add(r.c2, a.c2, b.c2);
}
__device__ __forceinline__ void fp6_sub(Fp6& r, const Fp6& a, const Fp6& b) {
  fp2_sub(r.c0, a.c0, b.c0);
  fp2_sub(r.c1, a.c1, b.c1);
  fp2_sub(r.c2, a.c2, b.c2);
}
__device__ __forceinline__ void fp6_neg(Fp6& r, const Fp6& a) {
  fp2_neg(r.c0, a.c0);
  fp2_neg(r.c1, a.c1);
  fp2_neg(r.c2, a.c2);
}
// v * (a0 + a1 v + a2 v^2) = a2 xi + a0 v + a1 v^2
__device__ __forceinline__ void fp6_mul_by_v(Fp6& r, const Fp6& a) {
  Fp2 t;
  fp2_mul_xi(t, a.c2);
  r.c2 = a.c1;
  r.c1 = a.c0;
  r.c0 = t;
}

__device__ __noinline__ void fp6_mul(Fp6& r, const Fp6& a, const Fp6& b) {
  Fp2 t0, t1, t2, x, y, c0, c1, c2;
  fp2_mul(t0, a.c0, b.c0);
  fp2_mul(t1, a.c1, b.c1);
  fp2_mul(t2, a.c2, b.c2);
  // c0 = t0 + ((a1 + a2)(b1 + b2) - t1 - t2) xi
  fp2_add(x, a.c1, a.c2);
  fp2_add(y, b.c1, b.c2);
  fp2_mul(x, x, y);
  fp2_sub(x, x, t1);
  fp2_sub(x, x, t2);
  fp2_mul_xi(x, x);
  fp2_add(c0, t0, x);
  // c1 = (a0 + a1)(b0 + b1) - t0 - t1 + t2 xi
  fp2_add(x, a.c0, a.c1);
  fp2_add(y, b.c0, b.c1);
  fp2_mul(x, x, y);
  fp2_sub(x, x, t0);
  fp2_sub(x, x, t1);
  fp2_mul_xi(y, t2);
  fp2_add(c1, x, y);
  // c2 = (a0 + a2)(b0 + b2) - t0 - t2 + t1
  fp2_add(x, a.c0, a.c2);
  fp2_add(y, b.c0, b.c2);
  fp2_mul(x, x, y);
  fp2_sub(x, x, t0);
  fp2_sub(x, x, t2);
  fp2_add(c2, x, t1);
  r.c0 = c0;
  r.c1 = c1;
  r.c2 = c2;
}

__device__ __noinline__ void fp6_inv(Fp6& r, const Fp6& a) {
  Fp2 t0, t1, t2, x, y, d;
  // t0 = a0^2 - a1 a2 xi;  t1 = a2^2 xi - a0 a1;  t2 = a1^2 - a0 a2
  fp2_sqr(t0, a.c0);
  fp2_mul(x, a.c1, a.c2);
  fp2_mul_xi(x, x);
  fp2_sub(t0, t0, x);
  fp2_sqr(t1, a.c2);
  fp2_mul_xi(t1, t1);
  fp2_mul(x, a.c0, a.c1);
  fp2_sub(t1, t1, x);
  fp2_sqr(t2, a.c1);
  fp2_mul(x, a.c0, a.c2);
  fp2_sub(t2, t2, x);
  // d = 1 / (a0 t0 + (a2 t1 + a1 t2) xi)
  fp2_mul(x, a.c2, t1);
  fp2_mul(y, a.c1, t2);
  fp2_add(x, x, y);
  fp2_mul_xi(x, x);
  fp2_mul(y, a.c0, t0);
  fp2_add(x, x, y);
  fp2_inv(d, x);
  fp2_mul(r.c0, t0, d);
  fp2_mul(r.c1, t1, d);
  fp2_mul(r.c2, t2, d);
}

// --- Fp12 = Fp6[w] / (w^2 - v) -------------------------------------------

__device__ __forceinline__ void fp12_one(Fp12& r) {
  fp2_one(r.c0.c0);
  fp2_zero(r.c0.c1);
  fp2_zero(r.c0.c2);
  fp2_zero(r.c1.c0);
  fp2_zero(r.c1.c1);
  fp2_zero(r.c1.c2);
}

__device__ __forceinline__ bool fp12_is_one(const Fp12& a) {
  Fp one;
  fp_one(one);
  return fp_eq(a.c0.c0.c0, one) && fp_is_zero(a.c0.c0.c1) &&
         fp2_is_zero(a.c0.c1) && fp2_is_zero(a.c0.c2) &&
         fp2_is_zero(a.c1.c0) && fp2_is_zero(a.c1.c1) &&
         fp2_is_zero(a.c1.c2);
}

// the Fp2 coefficient of w^i (w^0..w^5 = c0.c0, c1.c0, c0.c1, c1.c1,
// c0.c2, c1.c2)
__device__ __forceinline__ Fp2& fp12_slot(Fp12& a, int i) {
  Fp6& h = (i & 1) ? a.c1 : a.c0;
  int j = i >> 1;
  return j == 0 ? h.c0 : (j == 1 ? h.c1 : h.c2);
}

__device__ __forceinline__ void fp12_conj(Fp12& r, const Fp12& a) {
  r.c0 = a.c0;
  fp6_neg(r.c1, a.c1);
}

__device__ __noinline__ void fp12_mul(Fp12& r, const Fp12& a,
                                      const Fp12& b) {
  Fp6 t0, t1, x, y;
  fp6_mul(t0, a.c0, b.c0);
  fp6_mul(t1, a.c1, b.c1);
  fp6_add(x, a.c0, a.c1);
  fp6_add(y, b.c0, b.c1);
  fp6_mul(x, x, y);
  fp6_sub(x, x, t0);
  fp6_sub(r.c1, x, t1);
  fp6_mul_by_v(t1, t1);
  fp6_add(r.c0, t0, t1);
}

// complex squaring: c0 = (a0 + a1)(a0 + v a1) - t - v t, c1 = 2t, t = a0 a1
__device__ __noinline__ void fp12_sqr(Fp12& r, const Fp12& a) {
  Fp6 t, x, y;
  fp6_mul(t, a.c0, a.c1);
  fp6_add(x, a.c0, a.c1);
  fp6_mul_by_v(y, a.c1);
  fp6_add(y, a.c0, y);
  fp6_mul(x, x, y);
  fp6_sub(x, x, t);
  fp6_mul_by_v(y, t);
  fp6_sub(r.c0, x, y);
  fp6_add(r.c1, t, t);
}

__device__ __noinline__ void fp12_inv(Fp12& r, const Fp12& a) {
  Fp6 t0, t1, d;
  fp6_mul(t0, a.c0, a.c0);
  fp6_mul(t1, a.c1, a.c1);
  fp6_mul_by_v(t1, t1);
  fp6_sub(t0, t0, t1);
  fp6_inv(d, t0);
  fp6_mul(r.c0, a.c0, d);
  fp6_mul(t1, a.c1, d);
  fp6_neg(r.c1, t1);
}

// x -> x^(q^k): k times, conjugate each w^i coefficient and scale by
// gamma_i = xi^(i (q - 1) / 6)
__device__ __noinline__ void fp12_frobenius(Fp12& r, const Fp12& a, int k) {
  r = a;
  for (int n = 0; n < k % 12; ++n) {
    for (int i = 0; i < 6; ++i) {
      Fp2& c = fp12_slot(r, i);
      fp2_conj(c, c);
      fp2_mul(c, c, BLS.gamma[i]);
    }
  }
}

// --- boundary loads and stores of the tower -------------------------------

__device__ __forceinline__ void load_fp2(Fp2& r, const int32_t* src) {
  load_fp(r.c0, src);
  load_fp(r.c1, src + BLS_NL);
}
__device__ __forceinline__ void store_fp2(int32_t* dst, const Fp2& a) {
  store_fp(dst, a.c0);
  store_fp(dst + BLS_NL, a.c1);
}
__device__ __noinline__ void load_fp12(Fp12& r, const int32_t* src) {
  for (int i = 0; i < 3; ++i) {
    load_fp2(i == 0 ? r.c0.c0 : (i == 1 ? r.c0.c1 : r.c0.c2),
             src + 2 * BLS_NL * i);
    load_fp2(i == 0 ? r.c1.c0 : (i == 1 ? r.c1.c1 : r.c1.c2),
             src + 6 * BLS_NL + 2 * BLS_NL * i);
  }
}
__device__ __noinline__ void store_fp12(int32_t* dst, const Fp12& a) {
  store_fp2(dst, a.c0.c0);
  store_fp2(dst + 2 * BLS_NL, a.c0.c1);
  store_fp2(dst + 4 * BLS_NL, a.c0.c2);
  store_fp2(dst + 6 * BLS_NL, a.c1.c0);
  store_fp2(dst + 8 * BLS_NL, a.c1.c1);
  store_fp2(dst + 10 * BLS_NL, a.c1.c2);
}

// --- generic field interface for the curve code ----------------------------

// The generic curve code on Fp (the doubling in pt_add_finish's T = Q
// branch) takes one non-inlined Fp product, as the Fp2 code takes
// fp2_mul: with the products inlined, the serial pt_add on Fp spilled
// 5.8 KB.
__device__ __noinline__ void fp_mul_call(Fp& r, const Fp& a, const Fp& b) {
  fp_mul(r, a, b);
}
__device__ __forceinline__ void f_add(Fp& r, const Fp& a, const Fp& b) { fp_add(r, a, b); }
__device__ __forceinline__ void f_sub(Fp& r, const Fp& a, const Fp& b) { fp_sub(r, a, b); }
__device__ __forceinline__ void f_mul(Fp& r, const Fp& a, const Fp& b) { fp_mul_call(r, a, b); }
__device__ __forceinline__ void f_sqr(Fp& r, const Fp& a) { fp_mul_call(r, a, a); }
__device__ __forceinline__ bool f_is_zero(const Fp& a) { return fp_is_zero(a); }
__device__ __forceinline__ void f_one(Fp& r) { fp_one(r); }
__device__ __forceinline__ void f_zero(Fp& r) { fp_zero(r); }
__device__ __forceinline__ void f_inv(Fp& r, const Fp& a) { fp_inv(r, a); }
__device__ __forceinline__ void f_dbl(Fp& r, const Fp& a) { fp_dbl(r, a); }
__device__ __forceinline__ void f_neg(Fp& r, const Fp& a) { fp_neg(r, a); }
__device__ __forceinline__ void f_triple(Fp& r, const Fp& a) { fp_triple(r, a); }

__device__ __forceinline__ void f_add(Fp2& r, const Fp2& a, const Fp2& b) { fp2_add(r, a, b); }
__device__ __forceinline__ void f_sub(Fp2& r, const Fp2& a, const Fp2& b) { fp2_sub(r, a, b); }
__device__ __forceinline__ void f_mul(Fp2& r, const Fp2& a, const Fp2& b) { fp2_mul(r, a, b); }
__device__ __forceinline__ void f_sqr(Fp2& r, const Fp2& a) { fp2_sqr(r, a); }
__device__ __forceinline__ bool f_is_zero(const Fp2& a) { return fp2_is_zero(a); }
__device__ __forceinline__ void f_one(Fp2& r) { fp2_one(r); }
__device__ __forceinline__ void f_zero(Fp2& r) { fp2_zero(r); }
__device__ __forceinline__ void f_inv(Fp2& r, const Fp2& a) { fp2_inv(r, a); }
__device__ __forceinline__ void f_dbl(Fp2& r, const Fp2& a) { fp2_dbl(r, a); }
__device__ __forceinline__ void f_neg(Fp2& r, const Fp2& a) { fp2_neg(r, a); }
__device__ __forceinline__ void f_triple(Fp2& r, const Fp2& a) { fp2_triple(r, a); }

// --- Jacobian points (curve_jax.py pt_double / pt_add) --------------------

template <class F>
__device__ __forceinline__ void pt_infinity(Jac<F>& r) {
  f_one(r.x);
  f_one(r.y);
  f_zero(r.z);
}

// dbl-2007-bl; Z = 0 and Y = 0 both land on Z3 = 0.  pt_add's doubling
// branch inlines this body: as a nested call to a non-inlined doubling
// it faulted (illegal address) in the G1 FFT's butterfly rounds on sm_90a.
template <class F>
__device__ __forceinline__ void pt_double_body(Jac<F>& r, const Jac<F>& p) {
  F A, B, C, D, E, Fv, t, u;
  f_sqr(A, p.x);
  f_sqr(B, p.y);
  f_sqr(C, B);
  f_add(t, p.x, B);
  f_sqr(t, t);
  f_add(u, A, C);
  f_sub(t, t, u);
  f_add(D, t, t);                 // D = 2((X + B)^2 - A - C)
  f_add(E, A, A);
  f_add(E, E, A);                 // E = 3A
  f_sqr(Fv, E);
  f_add(u, D, D);
  F X3, Y3, Z3;
  f_sub(X3, Fv, u);               // X3 = F - 2D
  f_sub(t, D, X3);
  f_mul(t, E, t);
  f_add(u, C, C);
  f_add(u, u, u);
  f_add(u, u, u);                 // 8C
  f_sub(Y3, t, u);                // Y3 = E (D - X3) - 8C
  f_add(t, p.y, p.y);
  f_mul(Z3, t, p.z);              // Z3 = 2 Y Z
  r.x = X3;
  r.y = Y3;
  r.z = Z3;
}

// add-2007-bl; equal inputs double, opposite inputs give infinity, an
// infinite input gives the other (in curve_jax.pt_add's order of selects)
template <class F>
__device__ __noinline__ void pt_add(Jac<F>& r, const Jac<F>& p,
                                    const Jac<F>& q) {
  bool p_inf = f_is_zero(p.z), q_inf = f_is_zero(q.z);
  if (q_inf) { r = p; return; }
  if (p_inf) { r = q; return; }
  F Z1Z1, Z2Z2, U1, U2, S1, S2, H, rr, I, J, V, t;
  f_sqr(Z1Z1, p.z);
  f_sqr(Z2Z2, q.z);
  f_mul(U1, p.x, Z2Z2);
  f_mul(U2, q.x, Z1Z1);
  f_mul(t, Z2Z2, q.z);
  f_mul(S1, p.y, t);
  f_mul(t, Z1Z1, p.z);
  f_mul(S2, q.y, t);
  f_sub(H, U2, U1);
  f_sub(rr, S2, S1);
  if (f_is_zero(H)) {
    if (f_is_zero(rr)) pt_double_body(r, p);
    else pt_infinity(r);
    return;
  }
  f_add(rr, rr, rr);
  f_add(I, H, H);
  f_sqr(I, I);
  f_mul(J, H, I);
  f_mul(V, U1, I);
  F X3, Y3, Z3;
  f_sqr(X3, rr);
  f_sub(X3, X3, J);
  f_add(t, V, V);
  f_sub(X3, X3, t);               // X3 = r^2 - J - 2V
  f_sub(t, V, X3);
  f_mul(Y3, rr, t);
  f_mul(t, S1, J);
  f_add(t, t, t);
  f_sub(Y3, Y3, t);               // Y3 = r (V - X3) - 2 S1 J
  f_add(t, p.z, q.z);
  f_sqr(t, t);
  f_sub(t, t, Z1Z1);
  f_sub(t, t, Z2Z2);
  f_mul(Z3, t, H);                // Z3 = ((Z1 + Z2)^2 - Z1Z1 - Z2Z2) H
  r.x = X3;
  r.y = Y3;
  r.z = Z3;
}

// Jacobian -> affine, with inv0: (X / Z^2, Y / Z^3), Z = 0 -> (0, 0)
template <class F>
__device__ __forceinline__ bool pt_to_affine(F& x, F& y, const Jac<F>& p) {
  F zi, zi2, t;
  f_inv(zi, p.z);
  f_sqr(zi2, zi);
  f_mul(x, p.x, zi2);
  f_mul(t, zi2, zi);
  f_mul(y, p.y, t);
  return f_is_zero(p.z);
}

// --- host: the constant block ----------------------------------------------

// Write `BlsConstants` (the words of `kernels.constant_words()`) into this
// library's `__constant__` block, and raise the per-thread stack limit to
// the largest frame among its `kernels` (an Fp12 is 576 bytes and the
// frames are kilobytes), so that no launch is refused.  Each library has
// its own block: every one must be written before its first launch.
static int bls_write_constants(const uint32_t* words, int n_words,
                               const void* const* kernels, int n_kernels) {
  if (n_words * 4 != (int)sizeof(BlsConstants)) return cudaErrorInvalidValue;
  cudaError_t err = cudaMemcpyToSymbol(BLS, words, sizeof(BlsConstants));
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  size_t need = 0;
  for (int i = 0; i < n_kernels; ++i) {
    err = cudaFuncGetAttributes(&attr, kernels[i]);
    if (err != cudaSuccess) return err;
    if (attr.localSizeBytes > need) need = attr.localSizeBytes;
  }
  size_t cur = 0;
  err = cudaDeviceGetLimit(&cur, cudaLimitStackSize);
  if (err != cudaSuccess) return err;
  if (need > cur) err = cudaDeviceSetLimit(cudaLimitStackSize, need);
  return err;
}
