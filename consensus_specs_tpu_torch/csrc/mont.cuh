// Montgomery arithmetic over a prime field of NW 32-bit words: the core
// that the BLS12-381 base field Fp (`bls12_381.cuh`, 12 words, R = 2^384)
// and scalar field Fr (`fr.cuh`, 8 words, R = 2^256) both instantiate.
//
// A field is a tag type F with `static constexpr int NW` and a device
// function `F::k()` that returns its `MontConsts<NW>` block in constant
// memory.  An element `Mont<F>` is NW words, fully reduced in [0, m), in
// Montgomery form with R = 2^(32 NW); products are CIOS with 64-bit
// partial products.  Both moduli leave a spare top bit (m < 2^(32 NW - 1)),
// so a sum of two canonical values never carries out of the top word.
// Every value stays canonical, so each formula gives the unique canonical
// result and the kernels agree with the plain PyTorch versions (and JAX)
// at canonical values, bit for bit, whatever order their sums take.
//
// Boundary format: the port's tensors are JAX's (..., 33) int32 limbs of
// 12 bits in the R = 2^396 domain, possibly lazy.  `mont_load` accepts any
// such value (signed limbs, |limb| < 2^30) and `mont_store` writes
// canonical limbs.
//
// What bounds it: 32-bit integer multiply-add issue.  A Montgomery product
// is 2 x NW^2 32x32->64 multiply-adds; everything above it is counted in
// Montgomery products.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define MONT_NL 33   // 12-bit limbs of the boundary format
#define MONT_LW 13   // 32-bit words that hold the 396 bits of those limbs

// The constant block of a field with modulus m and R = 2^(32 NW).  The
// wrapper computes it from the modulus and writes it once.
template <int NW> struct MontConsts {
  uint32_t mod[NW];
  uint32_t mod_minus_2[NW];
  uint32_t one[NW];      // R mod m: Montgomery one
  uint32_t c_lo[NW];     // R^2 2^-396: mont(v, c_lo) = v R 2^-396
  uint32_t c_hi[NW];     // R^3 2^-396: mont(v, c_hi) = v R^2 2^-396
  uint32_t c_top[NW];    // R^2: mont(v, c_top) = v R
  uint32_t c_out[NW];    // 2^396: mont(x R, c_out) = x 2^396
  uint32_t n0;           // -m^-1 mod 2^32
};

template <class F> struct Mont { uint32_t w[F::NW]; };

template <class F>
__device__ __forceinline__ void mont_zero(Mont<F>& a) {
#pragma unroll
  for (int j = 0; j < F::NW; ++j) a.w[j] = 0;
}

template <class F>
__device__ __forceinline__ void mont_from_const(Mont<F>& a,
                                                const uint32_t* c) {
#pragma unroll
  for (int j = 0; j < F::NW; ++j) a.w[j] = c[j];
}

template <class F>
__device__ __forceinline__ void mont_one(Mont<F>& a) {
  mont_from_const(a, F::k().one);
}

template <class F>
__device__ __forceinline__ bool mont_is_zero(const Mont<F>& a) {
  uint32_t acc = 0;
#pragma unroll
  for (int j = 0; j < F::NW; ++j) acc |= a.w[j];
  return acc == 0;
}

template <class F>
__device__ __forceinline__ bool mont_eq(const Mont<F>& a, const Mont<F>& b) {
  uint32_t acc = 0;
#pragma unroll
  for (int j = 0; j < F::NW; ++j) acc |= a.w[j] ^ b.w[j];
  return acc == 0;
}

// a = t - m if (top:t) >= m, else t; (top:t) < 2m
template <class F>
__device__ __forceinline__ void mont_reduce_once(Mont<F>& a, const uint32_t* t,
                                                 uint32_t top) {
  uint32_t d[F::NW];
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < F::NW; ++j) {
    uint64_t s = (uint64_t)t[j] - F::k().mod[j] - borrow;
    d[j] = (uint32_t)s;
    borrow = (uint32_t)(s >> 63);
  }
  bool keep = (top == 0) && borrow;
#pragma unroll
  for (int j = 0; j < F::NW; ++j) a.w[j] = keep ? t[j] : d[j];
}

// Montgomery product a b R^-1 mod m (CIOS); a < R, b < m
template <class F>
__device__ __forceinline__ void mont_mul(Mont<F>& out, const Mont<F>& a,
                                         const Mont<F>& b) {
  constexpr int NW = F::NW;
  uint32_t t[NW + 2];
#pragma unroll
  for (int j = 0; j < NW + 2; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      uint64_t s = (uint64_t)a.w[j] * b.w[i] + t[j] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[NW] + c;
    t[NW] = (uint32_t)s;
    t[NW + 1] = (uint32_t)(s >> 32);
    uint32_t m = t[0] * F::k().n0;
    s = (uint64_t)m * F::k().mod[0] + t[0];
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < NW; ++j) {
      s = (uint64_t)m * F::k().mod[j] + t[j] + c;
      t[j - 1] = (uint32_t)s;
      c = s >> 32;
    }
    s = (uint64_t)t[NW] + c;
    t[NW - 1] = (uint32_t)s;
    t[NW] = t[NW + 1] + (uint32_t)(s >> 32);
  }
  mont_reduce_once(out, t, t[NW]);
}

template <class F>
__device__ __forceinline__ void mont_add(Mont<F>& out, const Mont<F>& a,
                                         const Mont<F>& b) {
  uint32_t t[F::NW];
  uint32_t c = 0;
#pragma unroll
  for (int j = 0; j < F::NW; ++j) {
    uint64_t s = (uint64_t)a.w[j] + b.w[j] + c;
    t[j] = (uint32_t)s;
    c = (uint32_t)(s >> 32);
  }
  mont_reduce_once(out, t, c);
}

template <class F>
__device__ __forceinline__ void mont_sub(Mont<F>& out, const Mont<F>& a,
                                         const Mont<F>& b) {
  uint32_t t[F::NW];
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < F::NW; ++j) {
    uint64_t s = (uint64_t)a.w[j] - b.w[j] - borrow;
    t[j] = (uint32_t)s;
    borrow = (uint32_t)(s >> 63);
  }
  uint32_t mask = 0u - borrow;            // add m back on a borrow
  uint32_t c = 0;
#pragma unroll
  for (int j = 0; j < F::NW; ++j) {
    uint64_t s = (uint64_t)t[j] + (F::k().mod[j] & mask) + c;
    out.w[j] = (uint32_t)s;
    c = (uint32_t)(s >> 32);
  }
}

// a^e for an exponent of NW little-endian words, square-and-multiply from
// e's leading bit.  e = 0 gives one; a = 0 gives 0 for e > 0 (so the
// Fermat inverse of 0 is 0).
template <class F>
__device__ __noinline__ void mont_pow(Mont<F>& out, const Mont<F>& a,
                                      const uint32_t* e) {
  int top = F::NW * 32 - 1;
  while (top >= 0 && !((e[top >> 5] >> (top & 31)) & 1)) --top;
  if (top < 0) {
    mont_one(out);
    return;
  }
  Mont<F> acc = a;
  for (int i = top - 1; i >= 0; --i) {
    mont_mul(acc, acc, acc);
    if ((e[i >> 5] >> (i & 31)) & 1) mont_mul(acc, acc, a);
  }
  out = acc;
}

// Fermat inversion a^(m - 2); 0 -> 0
template <class F>
__device__ __forceinline__ void mont_inv(Mont<F>& out, const Mont<F>& a) {
  mont_pow(out, a, F::k().mod_minus_2);
}

// boundary: (33,) int32 limbs, value v = x 2^396 (lazy) -> x R
template <class F>
__device__ __forceinline__ void mont_load(Mont<F>& out, const int32_t* src) {
  constexpr int NW = F::NW;
  uint32_t w[MONT_LW];
#pragma unroll
  for (int j = 0; j < MONT_LW; ++j) w[j] = 0;
  int64_t carry = 0;
#pragma unroll
  for (int k = 0; k < MONT_NL; ++k) {
    int64_t v = (int64_t)src[k] + carry;
    uint32_t d = (uint32_t)(v & 0xFFF);
    carry = v >> 12;                       // arithmetic: floor
    int bit = 12 * k, wi = bit >> 5, off = bit & 31;
    w[wi] |= d << off;
    if (off > 20) w[wi + 1] |= d >> (32 - off);
  }
  // v = lo + hi R + carry 2^396, lo < R, hi < 2^396 / R
  Mont<F> lo, hi, k;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    lo.w[j] = w[j];
    hi.w[j] = NW + j < MONT_LW ? w[NW + j] : 0;
  }
  mont_from_const(k, F::k().c_lo);
  mont_mul(out, lo, k);
  mont_from_const(k, F::k().c_hi);
  mont_mul(hi, hi, k);
  mont_add(out, out, hi);
  if (carry != 0) {
    Mont<F> c;
    mont_zero(c);
    c.w[0] = (uint32_t)(carry < 0 ? -carry : carry);
    mont_from_const(k, F::k().c_top);
    mont_mul(c, c, k);
    if (carry < 0) mont_sub(out, out, c); else mont_add(out, out, c);
  }
}

// x R -> canonical limbs of x 2^396 mod m
template <class F>
__device__ __forceinline__ void mont_store(int32_t* dst, const Mont<F>& a) {
  constexpr int NW = F::NW;
  Mont<F> k, b;
  mont_from_const(k, F::k().c_out);
  mont_mul(b, a, k);
#pragma unroll
  for (int i = 0; i < MONT_NL; ++i) {
    int bit = 12 * i, wi = bit >> 5, off = bit & 31;
    uint32_t v = wi < NW ? b.w[wi] >> off : 0;
    if (off > 20 && wi + 1 < NW) v |= b.w[wi + 1] << (32 - off);
    dst[i] = (int32_t)(v & 0xFFF);
  }
}
