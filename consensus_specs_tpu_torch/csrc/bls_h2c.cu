// Kernel K11 hash_to_g2: RFC 9380's random-oracle hash of B 32-byte
// message roots to G2, in affine form with an infinity flag.
//
// Replaces h2c_jax.py:295 hash_to_g2_dev (with :126 expand_message_xmd_dev,
// :157 _words512_to_fq_mont, :183 hash_to_field_fq2_dev, :198 fq2_sqrt_dev,
// :238 sgn0_fq2_dev, :261 svdw_map_g2_dev, and curve_jax.py:168
// pt_scalar_mul_const for the cofactor) and the g2_to_affine_dev that
// bls_batch/__init__.py:328 _rlc_kernel_h2c runs after it.
//
// Two launches, one kernel row:
//   map    a group of MAP_G = 4 threads per field element u (2B of them:
//          u0 of message i is element i, u1 is element B + i):
//          expand_message_xmd over sha256.cuh's compression (3
//          compressions for b0, 2 for each b_i it needs), the 512-bit
//          draws reduced into Fp, then the Shallue-van de Woestijne map
//          to an affine point on the twist
//   clear  a group of CLEAR_G = 12 threads per message: the two mapped
//          points added, the sum multiplied by the cofactor H2 by a
//          signed-window chain over a table of its odd multiples, then
//          to affine.
//
// The map branches where JAX selects, in the same priority: x1, then
// x2, then x3, the first whose x^3 + B is a square; inside the square
// root, JAX's candidate order (y == 0: sqrt(x), then sqrt(-x) u;
// otherwise c = sqrt((x + n) / 2) with n = sqrt(norm), then (x - n) / 2).
// Every value is canonical, so the points equal JAX's and the oracle's.
//
// Design (a first version ran one thread per element and per message,
// about 52,000 dependent Montgomery products per message, with the
// cofactor's 507 doublings and 247 additions on one thread):
//   - fixed exponents by sliding windows over a table of 16 odd powers
//     (`fp_pow_window` in `bls12_381.cuh`; digits in the constant block,
//     computed by the wrapper): p - 2 for
//     inversions; (p - 3) / 4 for square roots, since t^((p+1)/4) =
//     t * t^((p-3)/4) and t^((p-3)/4) is also +-1 / t^((p+1)/4), which
//     spares each root candidate its inversion;
//   - the map's three square-root tests side by side: g(x) is a square
//     in Fq2 iff its norm is one in Fp, so the group's ranks take the
//     norms of g(x1), g(x2), g(x3) at once, then the chosen g(x)'s two
//     root candidates at once: three exponentiations deep (the
//     inversion, a norm, a candidate) where the first version went
//     through up to ten;
//   - the cofactor by a width-5 signed window (wNAF) chain: 505
//     doublings and 86 additions of a table q, 3q, ..., 15q, H2 q itself
//     as JAX's pt_scalar_mul_const computes it;
//   - each doubling's and addition's independent Fp products over the
//     message's 12 threads through shared memory, every rank calling the
//     one Montgomery product on its own operands (a converged warp): a
//     doubling is 3 products deep, an addition 5.
//
// What bounds it: the dependent chain of one message (latency): the
// clearing's 505 doublings, then the map's three exponentiations.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bls12_381.cuh"
#include "sha256.cuh"

namespace {

#define H2C_EXP_DIGITS 384   // digits of the fixed exponents (<= 381 bits)
#define H2C_H2_DIGITS 512    // digits of H2 (508 at most)
#define H2C_H2_TABLE 8       // odd multiples q, 3q, ..., 15q

// the map's constants, from the port's oracle (`kernels.h2c_constant_words`)
struct H2cConstants {
  uint32_t b0_tpl[3][16];      // the three blocks of b0's input, message
                               // words 0..7 of block 1 left zero
  uint32_t bi_tpl[8][2][16];   // b_i's two blocks, digest words 0..7 zero
  int8_t e_sqrt[H2C_EXP_DIGITS];  // (p - 3) / 4: sliding-window digits,
  int8_t e_inv[H2C_EXP_DIGITS];   // p - 2       MSB first, odd or 0
  int8_t h2[H2C_H2_DIGITS];       // H2: signed-window digits, MSB first
  uint32_t e_sqrt_len, e_inv_len, h2_len;   // digits of each
  Fp inv2;                     // 1 / 2
  Fp2 c1, c2, c3, c4, z, b2;   // SVDW constants and the twist's B
};
static_assert(sizeof(H2cConstants) == 783 * 4, "h2c constant block layout");

__constant__ H2cConstants H2C;

// --- expand_message_xmd and hash_to_field ------------------------------------

__device__ __forceinline__ void sha_iv(uint32_t st[8]) {
  st[0] = 0x6a09e667u; st[1] = 0xbb67ae85u;
  st[2] = 0x3c6ef372u; st[3] = 0xa54ff53au;
  st[4] = 0x510e527fu; st[5] = 0x9b05688cu;
  st[6] = 0x1f83d9abu; st[7] = 0x5be0cd19u;
}

// one 64-byte draw (16 big-endian words, the 512-bit value u) -> u mod p:
// u = lo + hi 2^384 with lo < 2^384, so mont(lo, 2^768) = lo R and
// mont(mont(hi, 2^768), 2^768) = hi R^2 = (hi 2^384) R
__device__ __noinline__ void draw_to_fp(Fp& r, const uint32_t* be) {
  Fp lo, hi, k;
#pragma unroll
  for (int j = 0; j < BLS_NW; ++j) lo.w[j] = be[15 - j];
  fp_zero(hi);
#pragma unroll
  for (int j = 0; j < 4; ++j) hi.w[j] = be[3 - j];
  fp_from_const(k, BLS.f.c_top);
  fp_mul(r, lo, k);
  fp_mul(hi, hi, k);
  fp_mul(hi, hi, k);
  fp_add(r, r, hi);
}

// u_k (k = 0 or 1) of hash_to_field(msg, count = 2): the draws 2k and
// 2k + 1, which are b_(4k+1) .. b_(4k+4) of expand_message_xmd
__device__ __noinline__ void hash_to_field_elem(Fp2& u, const uint32_t msg[8],
                                                int k) {
  uint32_t b0[8], bi[8], w[16], draws[32];
  sha_iv(b0);
  for (int blk = 0; blk < 3; ++blk) {
    for (int j = 0; j < 16; ++j) w[j] = H2C.b0_tpl[blk][j];
    if (blk == 1)
      for (int j = 0; j < 8; ++j) w[j] = msg[j];
    cst::compress(b0, w);
  }
  for (int i = 1; i <= 4 * k + 4; ++i) {
    for (int j = 0; j < 8; ++j) w[j] = i == 1 ? b0[j] : b0[j] ^ bi[j];
    for (int j = 8; j < 16; ++j) w[j] = H2C.bi_tpl[i - 1][0][j];
    sha_iv(bi);
    cst::compress(bi, w);
    for (int j = 0; j < 16; ++j) w[j] = H2C.bi_tpl[i - 1][1][j];
    cst::compress(bi, w);
    if (i > 4 * k)
      for (int j = 0; j < 8; ++j) draws[8 * (i - 4 * k - 1) + j] = bi[j];
  }
  draw_to_fp(u.c0, draws);
  draw_to_fp(u.c1, draws + 16);
}

// --- fixed exponents, square root and sgn0 ----------------------------------

// (a0 - a1 u) / (a0^2 + a1^2), fp2_inv's formula, the Fp inversion by
// the digits of p - 2; 0 -> 0
__device__ __forceinline__ void h2c_fp2_inv(Fp2& r, const Fp2& a) {
  fp2_inv_window(r, a, H2C.e_inv, H2C.e_inv_len);
}

// c = t^((p + 1) / 4) = t s with s = t^((p - 3) / 4); c s = t^((p-1)/2)
// is 1, -1 or 0, so 1 / c is s, -s, or (t = 0, c = 0) 0 as inv0 gives
__device__ __noinline__ void fp_sqrt_cand(Fp& c, Fp& inv_c, const Fp& t) {
  Fp s, u, one;
  fp_pow_window(s, t, H2C.e_sqrt, H2C.e_sqrt_len);
  fp_mul(c, t, s);
  fp_mul(u, c, s);
  fp_one(one);
  if (fp_eq(u, one)) inv_c = s;
  else fp_neg(inv_c, s);
}

__device__ __forceinline__ bool fp2_eq(const Fp2& a, const Fp2& b) {
  return fp_eq(a.c0, b.c0) && fp_eq(a.c1, b.c1);
}

// r^2 == a?
__device__ __noinline__ bool fp2_is_root(const Fp2& r, const Fp2& a) {
  Fp2 s;
  fp2_sqr(s, r);
  return fp2_eq(s, a);
}

// RFC 9380 sgn0 of the plain (non-Montgomery) value
__device__ __noinline__ bool fp2_sgn0(const Fp2& a) {
  Fp one, x0, x1;
  fp_zero(one);
  one.w[0] = 1;
  fp_mul(x0, a.c0, one);
  fp_mul(x1, a.c1, one);
  return (x0.w[0] & 1) || (fp_is_zero(x0) && (x1.w[0] & 1));
}

// --- the SVDW map, by a group of MAP_G threads per field element --------------

#define MAP_G 4              // threads per field element
#define MAP_ELEMS 8          // elements per block: 32 threads

// RFC 9380 §6.6.1 straight line (hash_to_curve.py, h2c_jax.py:261), with
// fields.py Fq2.sqrt's branches (h2c_jax.py:198 fq2_sqrt_dev).  Every
// rank runs the same code on the same values (so the warp stays
// converged) but for the base of its two exponentiations: rank r takes
// the norm of g(x_min(r, 2)), then the root candidate r & 1 of the chosen
// g(x).  x is the first of x1, x2, x3 whose g(x) is a square, as JAX
// selects: g(x) is a square in Fq2 iff its norm is one in Fp (then, with
// y != 0, exactly one of the candidates (x + n) / 2, (x - n) / 2 is a
// square in Fp, and JAX's loop returns its root; y == 0 always has a
// root, sqrt(x) or sqrt(-x) u), and x3 is taken when x1 and x2 fail, the
// root then the first candidate that is one, else the second, as JAX's
// loop leaves it.  xch: the group's MAP_G shared slots, two barriers.
__device__ __noinline__ void svdw_map_group(Fp2& x, Fp2& y, const Fp2& u,
                                            int r, Fp* xch, Fp* xch2) {
  Fp2 one, tv1, tv2, tv3, tv4, t, xs[3], gx[3];
  Fp nrm[3], base, c, inv_c, tmp;
  fp2_one(one);
  fp2_sqr(tv1, u);
  fp2_mul(tv1, tv1, H2C.c1);
  fp2_add(tv2, one, tv1);
  fp2_sub(tv1, one, tv1);
  fp2_mul(tv3, tv1, tv2);
  h2c_fp2_inv(tv3, tv3);                // inv0: 0 -> 0
  fp2_mul(tv4, u, tv1);
  fp2_mul(t, tv3, H2C.c3);
  fp2_mul(tv4, tv4, t);
  fp2_sub(xs[0], H2C.c2, tv4);
  fp2_add(xs[1], H2C.c2, tv4);
  fp2_sqr(t, tv2);
  fp2_mul(t, t, tv3);
  fp2_sqr(t, t);
  fp2_mul(xs[2], t, H2C.c4);
  fp2_add(xs[2], xs[2], H2C.z);
  for (int k = 0; k < 3; ++k) {         // g(x) = x^3 + B and its norm
    fp2_sqr(gx[k], xs[k]);
    fp2_mul(gx[k], gx[k], xs[k]);
    fp2_add(gx[k], gx[k], H2C.b2);
    fp_sqr(nrm[k], gx[k].c0);
    fp_sqr(tmp, gx[k].c1);
    fp_add(nrm[k], nrm[k], tmp);
  }
  // n_k = sqrt of the norm, one k per rank; a square iff n_k^2 = norm
  fp_sqrt_cand(c, inv_c, nrm[r < 2 ? r : 2]);
  xch[r] = c;
  __syncthreads();
  int k = 2;
  for (int j = 1; j >= 0; --j) {
    fp_sqr(tmp, xch[j]);
    if (fp_eq(tmp, nrm[j])) k = j;
  }
  const Fp2 a = gx[k];
  const Fp n = xch[k];
  const bool y0 = fp_is_zero(a.c1);
  // the two root candidates, one per rank parity
  if (y0) {
    if (r & 1) fp_neg(base, a.c0);
    else base = a.c0;
  } else {
    if (r & 1) fp_sub(base, a.c0, n);
    else fp_add(base, a.c0, n);
    fp_mul(base, base, H2C.inv2);
  }
  fp_sqrt_cand(c, inv_c, base);
  __syncthreads();                      // every rank has read xch
  xch[r] = c;
  xch2[r] = inv_c;
  __syncthreads();
  Fp2 cand[2];
  if (y0) {                             // sqrt(x), then sqrt(-x) u
    cand[0].c0 = xch[0];
    fp_zero(cand[0].c1);
    fp_zero(cand[1].c0);
    cand[1].c1 = xch[1];
  } else {                              // c + y / (2c) u
    for (int j = 0; j < 2; ++j) {
      cand[j].c0 = xch[j];
      fp_mul(tmp, xch2[j], H2C.inv2);
      fp_mul(cand[j].c1, tmp, a.c1);
    }
  }
  y = fp2_is_root(cand[0], a) ? cand[0] : cand[1];
  x = xs[k];
  if (fp2_sgn0(u) != fp2_sgn0(y)) fp2_neg(y, y);
}

// --- the kernels ----------------------------------------------------------------

struct AffineG2 { Fp2 x, y; };

__global__ void __launch_bounds__(MAP_G * MAP_ELEMS)
h2c_map_kernel(const uint32_t* __restrict__ words, int B,
               AffineG2* __restrict__ mapped) {
  __shared__ Fp xch[MAP_ELEMS][MAP_G], xch2[MAP_ELEMS][MAP_G];
  const int g = threadIdx.x / MAP_G, r = threadIdx.x % MAP_G;
  const int e0 = blockIdx.x * MAP_ELEMS + g;
  const int e = e0 < 2 * B ? e0 : 2 * B - 1;  // a spare group redoes the
  const int m = e < B ? e : e - B;            // last element, unstored
  uint32_t msg[8];
  for (int j = 0; j < 8; ++j) msg[j] = words[8 * m + j];
  Fp2 u;
  hash_to_field_elem(u, msg, e < B ? 0 : 1);
  AffineG2 p;
  svdw_map_group(p.x, p.y, u, r, xch[g], xch2[g]);
  if (r == 0 && e0 < 2 * B) mapped[e] = p;
}

// --- the clearing: G2 doubling and addition by a group of CLEAR_G threads -----
//
// Each level of a doubling or an addition is a set of independent Fp
// products (the three of an Fq2 product a b: a0 b0, a1 b1,
// (a0 + a1)(b0 + b1); the two of a square: (a0 + a1)(a0 - a1), a0 a1),
// one per rank.  Every rank computes the level's operands from the
// previous levels' products (linear, a few additions), takes its own pair
// and calls the one Montgomery product, so the warp stays converged.

#define CLEAR_G 12           // threads per message
#define CLEAR_MSGS 8         // messages per block: 96 threads
#define CLEAR_SLOTS 43       // Fp products of one addition

struct ClearState {
  Jac<Fp2> acc, q2;
  Jac<Fp2> tab[H2C_H2_TABLE];
  Fp j[CLEAR_SLOTS];
};

// part `part` of a b (parts 0..2), of a^2 (parts 0..1)
__device__ __forceinline__ void mul_part(Fp& x, Fp& y, const Fp2& a,
                                         const Fp2& b, int part) {
  if (part == 0) {
    x = a.c0;
    y = b.c0;
  } else if (part == 1) {
    x = a.c1;
    y = b.c1;
  } else {
    fp_add(x, a.c0, a.c1);
    fp_add(y, b.c0, b.c1);
  }
}
__device__ __forceinline__ void sqr_part(Fp& x, Fp& y, const Fp2& a,
                                         int part) {
  if (part == 0) {
    fp_add(x, a.c0, a.c1);
    fp_sub(y, a.c0, a.c1);
  } else {
    x = a.c0;
    y = a.c1;
  }
}
// a b from its parts p[0..2]; a^2 from p[0..1]
__device__ __forceinline__ void from_mul(Fp2& c, const Fp* p) {
  Fp t;
  fp_add(t, p[0], p[1]);
  fp_sub(c.c0, p[0], p[1]);
  fp_sub(c.c1, p[2], t);
}
__device__ __forceinline__ void from_sqr(Fp2& c, const Fp* p) {
  c.c0 = p[0];
  fp_dbl(c.c1, p[1]);
}

// R = 2P (pt_double_body's formulas: A = X^2, B = Y^2, C = B^2,
// D = 2((X + B)^2 - A - C), E = 3A, F = E^2, X3 = F - 2D,
// Y3 = E (D - X3) - 8C, Z3 = 2 Y Z) in three levels of 7, 6 and 3
// products; every thread of the block calls it (four barriers), `act`
// false for a group without a message.  R may alias P.
__device__ __noinline__ void grp_dbl(Jac<Fp2>& R, const Jac<Fp2>& P, Fp* j,
                                     int r, bool act) {
  Fp x, y;
  Fp2 A, Bv, a;
  if (act && r < 7) {                       // A, B, Y Z
    if (r < 2) sqr_part(x, y, P.x, r);
    else if (r < 4) sqr_part(x, y, P.y, r - 2);
    else mul_part(x, y, P.y, P.z, r - 4);
    fp_mul(j[r], x, y);
  }
  __syncthreads();
  if (act && r < 6) {                       // C = B^2, (X + B)^2, F = E^2
    from_sqr(A, j);
    from_sqr(Bv, j + 2);
    if (r < 2) a = Bv;
    else if (r < 4) fp2_add(a, P.x, Bv);
    else fp2_triple(a, A);
    sqr_part(x, y, a, r & 1);
    fp_mul(j[7 + r], x, y);
  }
  __syncthreads();
  Fp2 C, T, F, D, X3, E, v;
  if (act) {
    from_sqr(A, j);
    from_sqr(C, j + 7);
    from_sqr(T, j + 9);
    from_sqr(F, j + 11);
    fp2_sub(D, T, A);
    fp2_sub(D, D, C);
    fp2_dbl(D, D);
    fp2_dbl(v, D);
    fp2_sub(X3, F, v);
    fp2_sub(v, D, X3);
    fp2_triple(E, A);
    if (r < 3) {                            // E (D - X3)
      mul_part(x, y, E, v, r);
      fp_mul(j[13 + r], x, y);
    }
  }
  __syncthreads();
  if (act && r == 0) {
    Fp2 YZ, u;
    from_mul(v, j + 13);
    fp2_dbl(u, C);
    fp2_dbl(u, u);
    fp2_dbl(u, u);
    fp2_sub(R.y, v, u);                     // Y3 = E (D - X3) - 8C
    R.x = X3;
    from_mul(YZ, j + 4);
    fp2_dbl(R.z, YZ);                       // Z3 = 2 Y Z
  }
  __syncthreads();
}

// R = P + (neg ? -Q : Q) (add-2007-bl: Z1Z1, Z2Z2; U1 = X1 Z2Z2,
// U2 = X2 Z1Z1, Z1^3, Z2^3; S1 = Y1 Z2^3, S2 = Y2 Z1^3, I = (2H)^2,
// (Z1 + Z2)^2; J = H I, V = U1 I, rr^2, Z3; rr (V - X3), S1 J: five
// levels of 4, 12, 10, 11 and 6 products), with pt_add's cases in its
// order: Q at infinity gives P, P at infinity gives Q, H = 0 doubles or
// gives infinity.  Every thread of the block calls it (six barriers
// whatever the case).  R may alias P.
__device__ __noinline__ void grp_add(Jac<Fp2>& R, const Jac<Fp2>& P,
                                     const Jac<Fp2>& Q, bool neg, Fp* j,
                                     int r, bool act) {
  Fp x, y;
  Fp2 Y2, a, b, Z1Z1, Z2Z2, U1, U2, H, rr;
  Y2 = Q.y;
  if (neg) fp2_neg(Y2, Q.y);
  if (act && r < 4) {
    sqr_part(x, y, r < 2 ? P.z : Q.z, r & 1);
    fp_mul(j[r], x, y);
  }
  __syncthreads();
  if (act) {                                // U1, U2, Z1^3, Z2^3
    from_sqr(Z1Z1, j);
    from_sqr(Z2Z2, j + 2);
    const int k = r / 3;
    if (k == 0) { a = P.x; b = Z2Z2; }
    else if (k == 1) { a = Q.x; b = Z1Z1; }
    else if (k == 2) { a = P.z; b = Z1Z1; }
    else { a = Q.z; b = Z2Z2; }
    mul_part(x, y, a, b, r % 3);
    fp_mul(j[4 + r], x, y);
  }
  __syncthreads();
  if (act && r < 10) {                      // S1, S2, I, (Z1 + Z2)^2
    from_mul(U1, j + 4);
    from_mul(U2, j + 7);
    fp2_sub(H, U2, U1);
    if (r < 6) {
      if (r < 3) a = P.y;
      else a = Y2;
      from_mul(b, j + (r < 3 ? 13 : 10));
      mul_part(x, y, a, b, r % 3);
    } else {
      if (r < 8) fp2_dbl(a, H);
      else fp2_add(a, P.z, Q.z);
      sqr_part(x, y, a, r & 1);
    }
    fp_mul(j[16 + r], x, y);
  }
  __syncthreads();
  Fp2 S1, S2, I;
  if (act) {
    from_mul(U1, j + 4);
    from_mul(U2, j + 7);
    fp2_sub(H, U2, U1);
    from_mul(S1, j + 16);
    from_mul(S2, j + 19);
    from_sqr(I, j + 22);
    fp2_sub(rr, S2, S1);
    fp2_dbl(rr, rr);
    if (r < 11) {                           // J, V, rr^2, Z3
      if (r < 3) { a = H; b = I; }
      else if (r < 6) { a = U1; b = I; }
      else if (r >= 8) {
        from_sqr(a, j + 24);
        from_sqr(Z1Z1, j);
        from_sqr(Z2Z2, j + 2);
        fp2_sub(a, a, Z1Z1);
        fp2_sub(a, a, Z2Z2);
        b = H;
      }
      if (r == 6 || r == 7) sqr_part(x, y, rr, r - 6);
      else mul_part(x, y, a, b, r < 8 ? r % 3 : r - 8);
      fp_mul(j[26 + r], x, y);
    }
  }
  __syncthreads();
  Fp2 J, V, X3;
  if (act) {
    from_mul(J, j + 26);
    from_mul(V, j + 29);
    from_sqr(X3, j + 32);
    fp2_sub(X3, X3, J);
    fp2_sub(X3, X3, V);
    fp2_sub(X3, X3, V);                     // rr^2 - J - 2V
    if (r < 6) {                            // rr (V - X3), S1 J
      if (r < 3) {
        fp2_sub(b, V, X3);
        mul_part(x, y, rr, b, r);
      } else {
        mul_part(x, y, S1, J, r - 3);
      }
      fp_mul(j[37 + r], x, y);
    }
  }
  __syncthreads();
  if (act && r == 0) {
    if (fp2_is_zero(Q.z)) {
      R = P;
    } else if (fp2_is_zero(P.z)) {
      R.x = Q.x;
      R.y = Y2;
      R.z = Q.z;
    } else if (fp2_is_zero(H)) {
      if (fp2_is_zero(rr)) pt_double_body(R, P);
      else pt_infinity(R);
    } else {
      Fp2 Y3, u;
      from_mul(Y3, j + 37);
      from_mul(u, j + 40);
      fp2_dbl(u, u);
      fp2_sub(R.y, Y3, u);                  // - 2 S1 J
      R.x = X3;
      from_mul(R.z, j + 34);
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(CLEAR_G * CLEAR_MSGS)
h2c_clear_kernel(const AffineG2* __restrict__ mapped, int B,
                 int32_t* __restrict__ hx, int32_t* __restrict__ hy,
                 uint8_t* __restrict__ h_ok) {
  __shared__ ClearState st[CLEAR_MSGS];
  const int g = threadIdx.x / CLEAR_G, r = threadIdx.x % CLEAR_G;
  const int m = blockIdx.x * CLEAR_MSGS + g;
  const bool act = m < B;
  ClearState& S = st[g];
  Fp* j = S.j;
  if (act && r == 0) {                      // u0's and u1's points, Z = 1
    S.acc.x = mapped[m].x;
    S.acc.y = mapped[m].y;
    fp2_one(S.acc.z);
    S.q2.x = mapped[B + m].x;
    S.q2.y = mapped[B + m].y;
    fp2_one(S.q2.z);
  }
  __syncthreads();
  // q = Q0 + Q1; the table q, 3q, ..., 15q
  grp_add(S.tab[0], S.acc, S.q2, false, j, r, act);
  grp_dbl(S.q2, S.tab[0], j, r, act);
  for (int k = 1; k < H2C_H2_TABLE; ++k)
    grp_add(S.tab[k], S.tab[k - 1], S.q2, false, j, r, act);
  // H2 q, the digits MSB first (the first positive)
  if (act && r == 0) S.acc = S.tab[H2C.h2[0] >> 1];
  __syncthreads();
  for (int k = 1; k < (int)H2C.h2_len; ++k) {
    grp_dbl(S.acc, S.acc, j, r, act);
    const int d = H2C.h2[k];
    if (d) grp_add(S.acc, S.acc, S.tab[(d < 0 ? -d : d) >> 1], d < 0, j, r,
                   act);
  }
  if (act && r == 0) {                      // to affine, inv0
    Fp2 zi, zi2, x, y, u;
    h2c_fp2_inv(zi, S.acc.z);
    fp2_sqr(zi2, zi);
    fp2_mul(x, S.acc.x, zi2);
    fp2_mul(u, zi2, zi);
    fp2_mul(y, S.acc.y, u);
    store_fp2(hx + m * 2 * BLS_NL, x);
    store_fp2(hy + m * 2 * BLS_NL, y);
    h_ok[m] = !fp2_is_zero(S.acc.z);
  }
}

}  // namespace

extern "C" {

int bls_set_constants(const uint32_t* words, int n_words) {
  const void* kernels[] = {(const void*)h2c_map_kernel,
                           (const void*)h2c_clear_kernel};
  return bls_write_constants(words, n_words, kernels, 2);
}

int h2c_set_constants(const uint32_t* words, int n_words) {
  if (n_words * 4 != (int)sizeof(H2cConstants)) return cudaErrorInvalidValue;
  return cudaMemcpyToSymbol(H2C, words, sizeof(H2cConstants));
}

// scratch: at least h2c_scratch_bytes(B) bytes, 16-byte aligned
int64_t h2c_scratch_bytes(int B) { return 2 * (int64_t)B * sizeof(AffineG2); }

int hash_to_g2_launch(const uint32_t* words, int B, void* scratch,
                      int32_t* hx, int32_t* hy, uint8_t* h_ok,
                      cudaStream_t stream) {
  AffineG2* mapped = (AffineG2*)scratch;
  h2c_map_kernel<<<(2 * B + MAP_ELEMS - 1) / MAP_ELEMS, MAP_G * MAP_ELEMS, 0,
                   stream>>>(words, B, mapped);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  h2c_clear_kernel<<<(B + CLEAR_MSGS - 1) / CLEAR_MSGS, CLEAR_G * CLEAR_MSGS,
                     0, stream>>>(mapped, B, hx, hy, h_ok);
  return cudaGetLastError();
}

}  // extern "C"
