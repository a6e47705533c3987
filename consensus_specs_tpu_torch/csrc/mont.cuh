// Montgomery arithmetic over a prime field of NW 32-bit words: the core
// that the BLS12-381 base field Fp (`bls12_381.cuh`, 12 words, R = 2^384)
// and scalar field Fr (`fr.cuh`, 8 words, R = 2^256) both instantiate.
//
// A field is a tag type F with `static constexpr int NW` and a device
// function `F::k()` that returns its `MontConsts<NW>` block in constant
// memory.  An element `Mont<F>` is NW words, fully reduced in [0, m), in
// Montgomery form with R = 2^(32 NW); products sum their 64-bit partial
// products by columns, and additions and subtractions are PTX carry
// chains.  Both moduli leave a spare top bit (m < 2^(32 NW - 1)),
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
// Montgomery products.  Most kernels are chains of dependent products on
// few threads, where latency counts: on an H100 80GB HBM3 at 700 W the
// column product and the PTX chains made every kernel timed 1-48% faster
// than a CIOS product with C++ carries did, but K7's fq12_mul over 1024
// elements (3% slower; K7 is on no path, it holds this layer).
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

// Montgomery product a b R^-1 mod m by columns (product scanning); a < R,
// b < m, so the sum below is < 2 R m and the result < 2m.  Column k of
// a b + M m (M = sum m_i 2^(32 i)) sums the low halves of its partial
// products and the high halves of column k - 1's in 64-bit accumulators,
// so a column's products are independent of each other; only m_k (which
// clears column k < NW), its product m_k m_0 and the carry into column
// k + 1 chain the columns.  Columns NW .. 2 NW - 1 are the result, < 2m.
template <class F>
__device__ __forceinline__ void mont_mul(Mont<F>& out, const Mont<F>& a,
                                         const Mont<F>& b) {
  constexpr int NW = F::NW;
  const uint32_t n0 = F::k().n0;
  uint32_t p[NW], m[NW], r[NW];
#pragma unroll
  for (int j = 0; j < NW; ++j) p[j] = F::k().mod[j];
  uint64_t carry = 0;
#pragma unroll
  for (int k = 0; k < 2 * NW; ++k) {
    uint64_t lo = carry, hi = 0;            // words at columns k and k + 1
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      if (i > k || k - i >= NW) continue;   // a_i b_(k-i)
      const uint64_t t = (uint64_t)a.w[i] * b.w[k - i];
      lo += (uint32_t)t;
      hi += t >> 32;
    }
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      if (i >= k || k - i >= NW) continue;  // m_i m_(k-i)
      const uint64_t t = (uint64_t)m[i] * p[k - i];
      lo += (uint32_t)t;
      hi += t >> 32;
    }
    if (k < NW) {                           // m_k clears column k
      m[k] = (uint32_t)lo * n0;
      const uint64_t t = (uint64_t)m[k] * p[0];
      lo += (uint32_t)t;
      hi += t >> 32;
    } else {
      r[k - NW] = (uint32_t)lo;
    }
    carry = (lo >> 32) + hi;
  }
  mont_reduce_once(out, r, (uint32_t)carry);
}

// The carry chains of the additions and subtractions, each one PTX block
// (`add.cc` .. `addc`, `sub.cc` .. `subc`), so that nothing the compiler
// emits can come between an instruction and the carry it reads: x += y
// mod 2^(32 NW), and x -= y returning all ones on a borrow (x < y).
template <int NW> struct Chain;

template <> struct Chain<8> {
  static __device__ __forceinline__ void add(uint32_t* x,
                                             const uint32_t* y) {
    asm("add.cc.u32 %0, %0, %8;\n\t"
        "addc.cc.u32 %1, %1, %9;\n\t"
        "addc.cc.u32 %2, %2, %10;\n\t"
        "addc.cc.u32 %3, %3, %11;\n\t"
        "addc.cc.u32 %4, %4, %12;\n\t"
        "addc.cc.u32 %5, %5, %13;\n\t"
        "addc.cc.u32 %6, %6, %14;\n\t"
        "addc.u32 %7, %7, %15;"
        : "+r"(x[0]), "+r"(x[1]), "+r"(x[2]), "+r"(x[3]), "+r"(x[4]),
          "+r"(x[5]), "+r"(x[6]), "+r"(x[7])
        : "r"(y[0]), "r"(y[1]), "r"(y[2]), "r"(y[3]), "r"(y[4]), "r"(y[5]),
          "r"(y[6]), "r"(y[7]));
  }
  static __device__ __forceinline__ uint32_t sub(uint32_t* x,
                                                 const uint32_t* y) {
    uint32_t borrow;
    asm("sub.cc.u32 %0, %0, %9;\n\t"
        "subc.cc.u32 %1, %1, %10;\n\t"
        "subc.cc.u32 %2, %2, %11;\n\t"
        "subc.cc.u32 %3, %3, %12;\n\t"
        "subc.cc.u32 %4, %4, %13;\n\t"
        "subc.cc.u32 %5, %5, %14;\n\t"
        "subc.cc.u32 %6, %6, %15;\n\t"
        "subc.cc.u32 %7, %7, %16;\n\t"
        "subc.u32 %8, 0, 0;"
        : "+r"(x[0]), "+r"(x[1]), "+r"(x[2]), "+r"(x[3]), "+r"(x[4]),
          "+r"(x[5]), "+r"(x[6]), "+r"(x[7]), "=r"(borrow)
        : "r"(y[0]), "r"(y[1]), "r"(y[2]), "r"(y[3]), "r"(y[4]), "r"(y[5]),
          "r"(y[6]), "r"(y[7]));
    return borrow;
  }
};

template <> struct Chain<12> {
  static __device__ __forceinline__ void add(uint32_t* x,
                                             const uint32_t* y) {
    asm("add.cc.u32 %0, %0, %12;\n\t"
        "addc.cc.u32 %1, %1, %13;\n\t"
        "addc.cc.u32 %2, %2, %14;\n\t"
        "addc.cc.u32 %3, %3, %15;\n\t"
        "addc.cc.u32 %4, %4, %16;\n\t"
        "addc.cc.u32 %5, %5, %17;\n\t"
        "addc.cc.u32 %6, %6, %18;\n\t"
        "addc.cc.u32 %7, %7, %19;\n\t"
        "addc.cc.u32 %8, %8, %20;\n\t"
        "addc.cc.u32 %9, %9, %21;\n\t"
        "addc.cc.u32 %10, %10, %22;\n\t"
        "addc.u32 %11, %11, %23;"
        : "+r"(x[0]), "+r"(x[1]), "+r"(x[2]), "+r"(x[3]), "+r"(x[4]),
          "+r"(x[5]), "+r"(x[6]), "+r"(x[7]), "+r"(x[8]), "+r"(x[9]),
          "+r"(x[10]), "+r"(x[11])
        : "r"(y[0]), "r"(y[1]), "r"(y[2]), "r"(y[3]), "r"(y[4]), "r"(y[5]),
          "r"(y[6]), "r"(y[7]), "r"(y[8]), "r"(y[9]), "r"(y[10]),
          "r"(y[11]));
  }
  static __device__ __forceinline__ uint32_t sub(uint32_t* x,
                                                 const uint32_t* y) {
    uint32_t borrow;
    asm("sub.cc.u32 %0, %0, %13;\n\t"
        "subc.cc.u32 %1, %1, %14;\n\t"
        "subc.cc.u32 %2, %2, %15;\n\t"
        "subc.cc.u32 %3, %3, %16;\n\t"
        "subc.cc.u32 %4, %4, %17;\n\t"
        "subc.cc.u32 %5, %5, %18;\n\t"
        "subc.cc.u32 %6, %6, %19;\n\t"
        "subc.cc.u32 %7, %7, %20;\n\t"
        "subc.cc.u32 %8, %8, %21;\n\t"
        "subc.cc.u32 %9, %9, %22;\n\t"
        "subc.cc.u32 %10, %10, %23;\n\t"
        "subc.cc.u32 %11, %11, %24;\n\t"
        "subc.u32 %12, 0, 0;"
        : "+r"(x[0]), "+r"(x[1]), "+r"(x[2]), "+r"(x[3]), "+r"(x[4]),
          "+r"(x[5]), "+r"(x[6]), "+r"(x[7]), "+r"(x[8]), "+r"(x[9]),
          "+r"(x[10]), "+r"(x[11]), "=r"(borrow)
        : "r"(y[0]), "r"(y[1]), "r"(y[2]), "r"(y[3]), "r"(y[4]), "r"(y[5]),
          "r"(y[6]), "r"(y[7]), "r"(y[8]), "r"(y[9]), "r"(y[10]),
          "r"(y[11]));
    return borrow;
  }
};

// a + b, both canonical: a + b < 2m never carries out (the spare bit)
template <class F>
__device__ __forceinline__ void mont_add(Mont<F>& out, const Mont<F>& a,
                                         const Mont<F>& b) {
  constexpr int NW = F::NW;
  uint32_t t[NW], d[NW], p[NW];
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    t[j] = a.w[j];
    p[j] = F::k().mod[j];
  }
  Chain<NW>::add(t, b.w);
#pragma unroll
  for (int j = 0; j < NW; ++j) d[j] = t[j];
  const uint32_t keep = Chain<NW>::sub(d, p);   // all ones: t < m
#pragma unroll
  for (int j = 0; j < NW; ++j) out.w[j] = (t[j] & keep) | (d[j] & ~keep);
}

// a - b, both canonical: m added back on a borrow
template <class F>
__device__ __forceinline__ void mont_sub(Mont<F>& out, const Mont<F>& a,
                                         const Mont<F>& b) {
  constexpr int NW = F::NW;
  uint32_t t[NW], p[NW];
#pragma unroll
  for (int j = 0; j < NW; ++j) t[j] = a.w[j];
  const uint32_t mask = Chain<NW>::sub(t, b.w);
#pragma unroll
  for (int j = 0; j < NW; ++j) p[j] = F::k().mod[j] & mask;
  Chain<NW>::add(t, p);
#pragma unroll
  for (int j = 0; j < NW; ++j) out.w[j] = t[j];
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

// Binary extended-Euclid inversion, a = x R -> x^-1 R, 0 -> 0: equal to
// mont_inv on every input, in far fewer dependent steps than its chain of
// products.  (u, v) run from (a, m) to (0, gcd = 1) with x1 a = u and
// x2 a = v (mod m): where u is odd, (u, v) becomes (|u - v|, min(u, v))
// and the x's follow; then u and x1 are halved (x1 mod m).  So x2 ends as
// a^-1 = x^-1 R^-1, and two products by R^2 give x^-1 R.  Every step
// shortens u and v by a bit between them (m < 2^(32 NW - 1): at most
// 2 (32 NW - 1) bits), so a fixed 64 NW steps suffice, and the steps are
// branch-free (masks), so a warp never diverges on the data.
template <class F>
__device__ __noinline__ void mont_inv_binary(Mont<F>& out, const Mont<F>& a) {
  constexpr int NW = F::NW;
  Mont<F> u = a, v, x1, x2, e, f;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    v.w[j] = F::k().mod[j];
    x1.w[j] = 0;
    x2.w[j] = 0;
  }
  x1.w[0] = 1;
  for (int step = 0; step < 64 * NW; ++step) {
    const uint32_t odd = 0u - (u.w[0] & 1);
    uint32_t d[NW], borrow = 0;
#pragma unroll
    for (int j = 0; j < NW; ++j) {          // d = u - v
      uint64_t s = (uint64_t)u.w[j] - v.w[j] - borrow;
      d[j] = (uint32_t)s;
      borrow = (uint32_t)(s >> 63);
    }
    const uint32_t lt = 0u - borrow;        // u < v
    const uint32_t swap = odd & lt;
    mont_sub(e, x1, x2);
    mont_sub(f, x2, x1);
    uint32_t c = 1;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      const uint32_t nd = ~d[j] + c;        // v - u = -d
      c = c & (nd == 0);
      const uint32_t diff = (nd & lt) | (d[j] & ~lt);
      const uint32_t dx = (f.w[j] & lt) | (e.w[j] & ~lt);
      v.w[j] = (u.w[j] & swap) | (v.w[j] & ~swap);
      x2.w[j] = (x1.w[j] & swap) | (x2.w[j] & ~swap);
      u.w[j] = (diff & odd) | (u.w[j] & ~odd);
      x1.w[j] = (dx & odd) | (x1.w[j] & ~odd);
    }
    const uint32_t x_odd = 0u - (x1.w[0] & 1);
    uint32_t cy = 0;
#pragma unroll
    for (int j = 0; j < NW; ++j) {          // x1 + m where x1 is odd: < 2m
      uint64_t s = (uint64_t)x1.w[j] + (F::k().mod[j] & x_odd) + cy;
      x1.w[j] = (uint32_t)s;
      cy = (uint32_t)(s >> 32);
    }
#pragma unroll
    for (int j = 0; j < NW - 1; ++j) {      // halve u and x1
      u.w[j] = (u.w[j] >> 1) | (u.w[j + 1] << 31);
      x1.w[j] = (x1.w[j] >> 1) | (x1.w[j + 1] << 31);
    }
    u.w[NW - 1] >>= 1;
    x1.w[NW - 1] >>= 1;
  }
  Mont<F> k;
  mont_from_const(k, F::k().c_top);         // R^2
  mont_mul(out, x2, k);
  mont_mul(out, out, k);
}

// (33,) int32 limbs (lazy) -> their value v = w + carry 2^396, w the
// 396 bits of w[0 .. MONT_LW)
__device__ __forceinline__ int64_t mont_pack(uint32_t* w, const int32_t* src) {
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
  return carry;
}

// boundary: (33,) int32 limbs, value v = x 2^396 (lazy) -> x R, its
// products by `mul` (a product r = mont(a, b); `mont_load` inlines
// mont_mul, a kernel that keeps its code small passes a non-inlined one).
// With `skip_hi` the product of v's bits from 32 NW up is skipped where
// they are 0, as they are for canonical limbs (v < m < R).
template <class F, bool skip_hi = false, class Mul>
__device__ __forceinline__ void mont_load_by(Mont<F>& out, const int32_t* src,
                                             Mul mul) {
  constexpr int NW = F::NW;
  uint32_t w[MONT_LW];
  const int64_t carry = mont_pack(w, src);
  // v = lo + hi R + carry 2^396, lo < R, hi < 2^396 / R
  Mont<F> lo, hi, k;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    lo.w[j] = w[j];
    hi.w[j] = NW + j < MONT_LW ? w[NW + j] : 0;
  }
  mont_from_const(k, F::k().c_lo);
  mul(out, lo, k);
  if (!skip_hi || !mont_is_zero(hi)) {
    mont_from_const(k, F::k().c_hi);
    mul(hi, hi, k);
    mont_add(out, out, hi);
  }
  if (carry != 0) {
    Mont<F> c;
    mont_zero(c);
    c.w[0] = (uint32_t)(carry < 0 ? -carry : carry);
    mont_from_const(k, F::k().c_top);
    mul(c, c, k);
    if (carry < 0) mont_sub(out, out, c); else mont_add(out, out, c);
  }
}

template <class F>
__device__ __forceinline__ void mont_load(Mont<F>& out, const int32_t* src) {
  mont_load_by(out, src, [](Mont<F>& r, const Mont<F>& a, const Mont<F>& b) {
    mont_mul(r, a, b);
  });
}

// x R, k -> canonical limbs of mont(x R, k) = x k mod m, the product by
// `mul`; k = c_out (2^396) gives the boundary format, k = mont(s R, c_out)
// = s 2^396 the value times s in one product
template <class F, class Mul>
__device__ __forceinline__ void mont_store_times_by(int32_t* dst,
                                                    const Mont<F>& a,
                                                    const Mont<F>& k,
                                                    Mul mul) {
  constexpr int NW = F::NW;
  Mont<F> b;
  mul(b, a, k);
#pragma unroll
  for (int i = 0; i < MONT_NL; ++i) {
    int bit = 12 * i, wi = bit >> 5, off = bit & 31;
    uint32_t v = wi < NW ? b.w[wi] >> off : 0;
    if (off > 20 && wi + 1 < NW) v |= b.w[wi + 1] << (32 - off);
    dst[i] = (int32_t)(v & 0xFFF);
  }
}

// x R -> canonical limbs of x 2^396 mod m
template <class F>
__device__ __forceinline__ void mont_store(int32_t* dst, const Mont<F>& a) {
  Mont<F> k;
  mont_from_const(k, F::k().c_out);
  mont_store_times_by(dst, a, k,
                      [](Mont<F>& r, const Mont<F>& x, const Mont<F>& y) {
                        mont_mul(r, x, y);
                      });
}
