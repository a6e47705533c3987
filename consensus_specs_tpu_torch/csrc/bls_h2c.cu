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
//   map    one thread per field element u (2B of them: u0 of message i
//          is element i, u1 is element B + i): expand_message_xmd over
//          sha256.cuh's compression (3 compressions for b0, 2 for each
//          b_i it needs), the 512-bit draws reduced into Fp, then the
//          Shallue-van de Woestijne map to an affine point on the twist
//   clear  one thread per message: the two mapped points added, the sum
//          multiplied by the cofactor H2 MSB first (507 doublings, 247
//          additions), then to affine.
//
// The map branches where JAX selects, in the same priority: x1, then
// x2, then x3, the first whose x^3 + B is a square; inside the square
// root, JAX's candidate order (y == 0: sqrt(x), then sqrt(-x) u;
// otherwise c = sqrt((x + n) / 2) with n = sqrt(norm), then (x - n) / 2).
// Every value is canonical, so the points equal JAX's and the oracle's.
//
// What bounds it: a chain of about 52,000 dependent Montgomery products
// per message on one thread (two maps of about 13,000, mostly four
// exponentiations by (p + 1) / 4 or p - 2 each, and about 24,500 for the
// cofactor), with only 2B or B threads busy: latency, not issue.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bls12_381.cuh"
#include "sha256.cuh"

namespace {

// the map's constants, from the port's oracle (`kernels.h2c_constant_words`)
struct H2cConstants {
  uint32_t b0_tpl[3][16];      // the three blocks of b0's input, message
                               // words 0..7 of block 1 left zero
  uint32_t bi_tpl[8][2][16];   // b_i's two blocks, digest words 0..7 zero
  uint32_t p14[BLS_NW];        // (p + 1) / 4
  uint32_t h2[16];             // the G2 cofactor H2, little-endian words
  uint32_t h2_bits;            // its bit length
  Fp inv2;                     // 1 / 2
  Fp2 c1, c2, c3, c4, z, b2;   // SVDW constants and the twist's B
};
static_assert(sizeof(H2cConstants) == 489 * 4, "h2c constant block layout");

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

// --- square root and sgn0 ----------------------------------------------------

__device__ __forceinline__ void fp_pow_p14(Fp& r, const Fp& a) {
  mont_pow(r, a, H2C.p14);
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

// Fq2 square root in the oracle's branch order (fields.py Fq2.sqrt,
// h2c_jax.py:198 fq2_sqrt_dev); returns whether a is a square, r the
// root JAX selects when it is
__device__ __noinline__ bool fp2_sqrt(Fp2& r, const Fp2& a) {
  if (fp_is_zero(a.c1)) {               // y == 0: sqrt(x), else sqrt(-x) u
    fp_pow_p14(r.c0, a.c0);
    fp_zero(r.c1);
    if (fp2_is_root(r, a)) return true;
    Fp nx;
    fp_neg(nx, a.c0);
    fp_zero(r.c0);
    fp_pow_p14(r.c1, nx);
    return fp2_is_root(r, a);
  }
  Fp n, t;
  fp_sqr(n, a.c0);
  fp_sqr(t, a.c1);
  fp_add(n, n, t);
  fp_pow_p14(n, n);                     // sqrt of the norm
  for (int sign = 0; sign < 2; ++sign) {
    if (sign == 0) fp_add(t, a.c0, n);
    else fp_sub(t, a.c0, n);
    fp_mul(t, t, H2C.inv2);
    fp_pow_p14(r.c0, t);                // c = sqrt((x +- n) / 2)
    fp_dbl(t, r.c0);
    fp_inv(t, t);
    fp_mul(r.c1, t, a.c1);              // y / (2c)
    if (fp2_is_root(r, a)) return true;
  }
  return false;
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

// --- the SVDW map -------------------------------------------------------------

// RFC 9380 §6.6.1 straight line (hash_to_curve.py, h2c_jax.py:261)
__device__ __noinline__ void svdw_map(Fp2& x, Fp2& y, const Fp2& u) {
  Fp2 one, tv1, tv2, tv3, tv4, t, xs[3];
  fp2_one(one);
  fp2_sqr(tv1, u);
  fp2_mul(tv1, tv1, H2C.c1);
  fp2_add(tv2, one, tv1);
  fp2_sub(tv1, one, tv1);
  fp2_mul(tv3, tv1, tv2);
  fp2_inv(tv3, tv3);                    // inv0: 0 -> 0
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
  // the first x with x^3 + B a square, in the order x1, x2, x3
  for (int k = 0; k < 3; ++k) {
    Fp2 gx;
    fp2_sqr(gx, xs[k]);
    fp2_mul(gx, gx, xs[k]);
    fp2_add(gx, gx, H2C.b2);
    if (fp2_sqrt(y, gx) || k == 2) {
      x = xs[k];
      break;
    }
  }
  if (fp2_sgn0(u) != fp2_sgn0(y)) fp2_neg(y, y);
}

// --- the kernels ----------------------------------------------------------------

struct AffineG2 { Fp2 x, y; };

__global__ void __launch_bounds__(32)
h2c_map_kernel(const uint32_t* __restrict__ words, int B,
               AffineG2* __restrict__ mapped) {
  int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= 2 * B) return;
  const int m = e < B ? e : e - B;
  uint32_t msg[8];
  for (int j = 0; j < 8; ++j) msg[j] = words[8 * m + j];
  Fp2 u;
  hash_to_field_elem(u, msg, e < B ? 0 : 1);
  AffineG2 p;
  svdw_map(p.x, p.y, u);
  mapped[e] = p;
}

__global__ void __launch_bounds__(32)
h2c_clear_kernel(const AffineG2* __restrict__ mapped, int B,
                 int32_t* __restrict__ hx, int32_t* __restrict__ hy,
                 uint8_t* __restrict__ h_ok) {
  int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= B) return;
  Jac<Fp2> q, p1, acc;
  q.x = mapped[m].x;
  q.y = mapped[m].y;
  fp2_one(q.z);
  p1.x = mapped[B + m].x;
  p1.y = mapped[B + m].y;
  fp2_one(p1.z);
  pt_add(q, q, p1);
  pt_infinity(acc);
  for (int i = (int)H2C.h2_bits - 1; i >= 0; --i) {
    pt_double(acc, acc);
    if ((H2C.h2[i >> 5] >> (i & 31)) & 1) pt_add(acc, acc, q);
  }
  Fp2 x, y;
  bool inf = pt_to_affine(x, y, acc);
  store_fp2(hx + m * 2 * BLS_NL, x);
  store_fp2(hy + m * 2 * BLS_NL, y);
  h_ok[m] = !inf;
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
  h2c_map_kernel<<<(2 * B + 31) / 32, 32, 0, stream>>>(words, B, mapped);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  h2c_clear_kernel<<<(B + 31) / 32, 32, 0, stream>>>(mapped, B, hx, hy, h_ok);
  return cudaGetLastError();
}

}  // extern "C"
