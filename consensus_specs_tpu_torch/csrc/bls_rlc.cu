// Kernels K7-K10: the random-linear-combination (RLC) batch verify of B
// FastAggregateVerify statements, host-hashed, and a field-op kernel that
// holds the device arithmetic against the plain versions.
//
//   K7 bls_field_ops       one of fq_mul, fq_inv, fq_canon, fq2_mul,
//                          fq2_inv, fq12_mul, fq12_sqr, fq12_inv,
//                          fq12_frobenius(k), elementwise (holds rows 7-8
//                          of the kernel table; not on the main path)
//   K8 rlc_scalar_mul      r_i PK_i (G1, to affine with an infinity flag)
//                          and r_i S_i (G2, Jacobian; pad lanes infinity)
//                          by 128-bit MSB-first double-and-add
//                          (replaces curve_jax.py:147 pt_scalar_mul and
//                          bls_batch/__init__.py:200 g1_to_affine_dev,
//                          as `_rlc_pairing_core` runs them)
//   K9 rlc_miller_product  the tree sum of the signature lanes
//                          (curve_jax.py:252 pt_sum) and its affine form
//                          (bls_batch/__init__.py:209), then the shared-
//                          accumulator Miller product over the B + 1 lanes
//                          (r_i PK_i, H_i) and (-G1, sum)
//                          (pairing_jax.py:133 miller_product_batch)
//   K10 final_exp_is_one   pairing_jax.py:297 final_exponentiate (the
//                          cube of the standard pairing value) and
//                          tower.py fq12_is_one
//
// Inputs and outputs are the port's boundary format (bls12_381.cuh):
// (..., 33) int32 limbs, R = 2^396; outputs are canonical.
//
// Design, first version: the work is a chain of dependent Montgomery
// products per lane, and one batch has only B + 1 = 129 lanes, far less
// than one wave of the card, so every kernel is latency-bound, not
// issue-bound.  K8 runs one thread per lane and group (32-thread blocks,
// one warp per SM).  K9 is one block: one thread per lane computes its
// line each Miller step into a global scratch row, the block multiplies
// the lines in a tree (128 Fq12 products in 8 levels per step), and
// thread 0 folds the product into the accumulator (the line placement,
// the tree and the fold are `bls_miller.cuh`'s, shared with K12; the
// whole body is `bls_rlc_body.cuh`'s, shared with K25 and K26).  K10
// is one thread.
// Every launcher returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "bls12_381.cuh"
#include "bls_miller.cuh"
#include "bls_rlc_body.cuh"

namespace {

enum FieldOp {
  OP_FQ_MUL = 0, OP_FQ_INV, OP_FQ_CANON, OP_FQ2_MUL, OP_FQ2_INV,
  OP_FQ12_MUL, OP_FQ12_SQR, OP_FQ12_INV, OP_FQ12_FROBENIUS
};

// --- K7 --------------------------------------------------------------------

__global__ void __launch_bounds__(64)
bls_field_ops_kernel(int op, int k, const int32_t* __restrict__ a,
                     const int32_t* __restrict__ b, int32_t* __restrict__ out,
                     int64_t n) {
  int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  if (op <= OP_FQ_CANON) {
    Fp x, y;
    load_fp(x, a + e * BLS_NL);
    if (op == OP_FQ_MUL) {
      load_fp(y, b + e * BLS_NL);
      fp_mul(x, x, y);
    } else if (op == OP_FQ_INV) {
      fp_inv(x, x);
    }
    store_fp(out + e * BLS_NL, x);
  } else if (op <= OP_FQ2_INV) {
    Fp2 x, y;
    load_fp2(x, a + e * 2 * BLS_NL);
    if (op == OP_FQ2_MUL) {
      load_fp2(y, b + e * 2 * BLS_NL);
      fp2_mul(x, x, y);
    } else {
      fp2_inv(x, x);
    }
    store_fp2(out + e * 2 * BLS_NL, x);
  } else {
    Fp12 x, y;
    load_fp12(x, a + e * 12 * BLS_NL);
    if (op == OP_FQ12_MUL) {
      load_fp12(y, b + e * 12 * BLS_NL);
      fp12_mul(x, x, y);
    } else if (op == OP_FQ12_SQR) {
      fp12_sqr(x, x);
    } else if (op == OP_FQ12_INV) {
      fp12_inv(x, x);
    } else {
      fp12_frobenius(x, x, k);
    }
    store_fp12(out + e * 12 * BLS_NL, x);
  }
}

// --- K8 --------------------------------------------------------------------

__global__ void __launch_bounds__(32)
rlc_scalar_mul_kernel(const int32_t* __restrict__ pk_x,
                      const int32_t* __restrict__ pk_y,
                      const int32_t* __restrict__ sig_x,
                      const int32_t* __restrict__ sig_y,
                      const int32_t* __restrict__ bits,
                      const uint8_t* __restrict__ mask, int nbits, int B,
                      int32_t* __restrict__ apx, int32_t* __restrict__ apy,
                      uint8_t* __restrict__ a_inf, int32_t* __restrict__ sX,
                      int32_t* __restrict__ sY, int32_t* __restrict__ sZ) {
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  const int32_t* lane_bits = bits + (int64_t)lane * nbits;
  if (blockIdx.y == 0) {                    // G1: r PK, then affine
    Jac<Fp> p, acc;
    load_fp(p.x, pk_x + lane * BLS_NL);
    load_fp(p.y, pk_y + lane * BLS_NL);
    fp_one(p.z);
    pt_infinity(acc);
    for (int i = 0; i < nbits; ++i) {
      pt_double(acc, acc);
      if (lane_bits[i]) pt_add(acc, acc, p);
    }
    Fp x, y;
    bool inf = pt_to_affine(x, y, acc);
    store_fp(apx + lane * BLS_NL, x);
    store_fp(apy + lane * BLS_NL, y);
    a_inf[lane] = inf;
  } else {                                  // G2: r S, Jacobian
    Jac<Fp2> p, acc;
    load_fp2(p.x, sig_x + lane * 2 * BLS_NL);
    load_fp2(p.y, sig_y + lane * 2 * BLS_NL);
    fp2_one(p.z);
    pt_infinity(acc);
    for (int i = 0; i < nbits; ++i) {
      pt_double(acc, acc);
      if (lane_bits[i]) pt_add(acc, acc, p);
    }
    if (!mask[lane]) pt_infinity(acc);      // pad lanes leave the sum
    store_fp2(sX + lane * 2 * BLS_NL, acc.x);
    store_fp2(sY + lane * 2 * BLS_NL, acc.y);
    store_fp2(sZ + lane * 2 * BLS_NL, acc.z);
  }
}

// --- K9 --------------------------------------------------------------------

__global__ void __launch_bounds__(256)
rlc_miller_product_kernel(const int32_t* __restrict__ apx,
                          const int32_t* __restrict__ apy,
                          const uint8_t* __restrict__ a_inf,
                          const int32_t* __restrict__ sX,
                          const int32_t* __restrict__ sY,
                          const int32_t* __restrict__ sZ,
                          const int32_t* __restrict__ hx,
                          const int32_t* __restrict__ hy,
                          const uint8_t* __restrict__ h_ok,
                          const uint8_t* __restrict__ mask,
                          const int32_t* __restrict__ g1x,
                          const int32_t* __restrict__ g1y, int B, int m,
                          MillerScratch s, int32_t* __restrict__ f_out,
                          int32_t* __restrict__ sum_out,
                          uint8_t* __restrict__ s_inf_out) {
  Fp12 f = rlc_miller_body<true, true>(apx, apy, a_inf, sX, sY, sZ, hx, hy,
                                       h_ok, mask, g1x, g1y, B, m, s, sum_out,
                                       s_inf_out);
  if (threadIdx.x == 0) store_fp12(f_out, f);
}

// --- K10 -------------------------------------------------------------------

__device__ __noinline__ void fp12_pow_x_abs(Fp12& r, const Fp12& g) {
  const uint64_t x_abs = bls_x_abs();
  Fp12 acc;
  fp12_one(acc);
  for (int bit = 63; bit >= 0; --bit) {
    fp12_sqr(acc, acc);
    if ((x_abs >> bit) & 1) fp12_mul(acc, acc, g);
  }
  r = acc;
}

// g^x (x negative): conj(g^|x|)
__device__ __noinline__ void fp12_pow_x(Fp12& r, const Fp12& g) {
  fp12_pow_x_abs(r, g);
  fp12_conj(r, r);
}

__global__ void __launch_bounds__(1)
final_exp_is_one_kernel(const int32_t* __restrict__ f_in,
                        int32_t* __restrict__ fe_out,
                        uint8_t* __restrict__ ok) {
  Fp12 f, f1, m, t, u, t1, t2, t3;
  load_fp12(f, f_in);
  // easy part: f^((q^6 - 1)(q^2 + 1))
  fp12_conj(t, f);
  fp12_inv(u, f);
  fp12_mul(f1, t, u);
  fp12_frobenius(t, f1, 2);
  fp12_mul(m, t, f1);
  // t1 = m^((x - 1)^2): pow_xm1(g) = g^x conj(g), twice
  fp12_pow_x(t, m);
  fp12_conj(u, m);
  fp12_mul(t, t, u);
  fp12_pow_x(t1, t);
  fp12_conj(u, t);
  fp12_mul(t1, t1, u);
  // t2 = t1^x frob(t1, 1)
  fp12_pow_x(t2, t1);
  fp12_frobenius(u, t1, 1);
  fp12_mul(t2, t2, u);
  // t3 = (t2^x)^x frob(t2, 2) conj(t2)
  fp12_pow_x(t3, t2);
  fp12_pow_x(t3, t3);
  fp12_frobenius(u, t2, 2);
  fp12_mul(t3, t3, u);
  fp12_conj(u, t2);
  fp12_mul(t3, t3, u);
  // result = t3 m^3
  fp12_sqr(u, m);
  fp12_mul(u, u, m);
  fp12_mul(t3, t3, u);
  store_fp12(fe_out, t3);
  *ok = fp12_is_one(t3);
}

}  // namespace

extern "C" {

int bls_set_constants(const uint32_t* words, int n_words) {
  const void* kernels[] = {(const void*)bls_field_ops_kernel,
                           (const void*)rlc_scalar_mul_kernel,
                           (const void*)rlc_miller_product_kernel,
                           (const void*)final_exp_is_one_kernel};
  return bls_write_constants(words, n_words, kernels, 4);
}

int bls_field_ops_launch(int op, int k, const int32_t* a, const int32_t* b,
                         int32_t* out, int64_t n, cudaStream_t stream) {
  const int threads = 64;
  int64_t blocks = (n + threads - 1) / threads;
  bls_field_ops_kernel<<<(unsigned)blocks, threads, 0, stream>>>(op, k, a, b,
                                                                  out, n);
  return cudaGetLastError();
}

int rlc_scalar_mul_launch(const int32_t* pk_x, const int32_t* pk_y,
                          const int32_t* sig_x, const int32_t* sig_y,
                          const int32_t* bits, const uint8_t* mask, int nbits,
                          int B, int32_t* apx, int32_t* apy, uint8_t* a_inf,
                          int32_t* sX, int32_t* sY, int32_t* sZ,
                          cudaStream_t stream) {
  dim3 grid((B + 31) / 32, 2);
  rlc_scalar_mul_kernel<<<grid, 32, 0, stream>>>(
      pk_x, pk_y, sig_x, sig_y, bits, mask, nbits, B, apx, apy, a_inf, sX,
      sY, sZ);
  return cudaGetLastError();
}

// scratch: at least rlc_miller_scratch_bytes(B) bytes, 16-byte aligned
int64_t rlc_miller_scratch_bytes(int B) {
  int64_t m = 1;
  while (m < B) m *= 2;
  int64_t n = B + 1;
  return m * sizeof(Jac<Fp2>) + n * (sizeof(Jac<Fp2>) + sizeof(Fp12) +
                                     2 * sizeof(Fp2) + 2 * sizeof(Fp) + 1);
}

int rlc_miller_product_launch(
    const int32_t* apx, const int32_t* apy, const uint8_t* a_inf,
    const int32_t* sX, const int32_t* sY, const int32_t* sZ,
    const int32_t* hx, const int32_t* hy, const uint8_t* h_ok,
    const uint8_t* mask, const int32_t* g1x, const int32_t* g1y, int B,
    void* scratch, int32_t* f_out, int32_t* sum_out, uint8_t* s_inf_out,
    int threads, cudaStream_t stream) {
  int m = 1;
  while (m < B) m *= 2;
  int n = B + 1;
  char* base = (char*)scratch;
  MillerScratch s;
  s.sums = (Jac<Fp2>*)base;
  base += (size_t)m * sizeof(Jac<Fp2>);
  s.T = (Jac<Fp2>*)base;
  base += (size_t)n * sizeof(Jac<Fp2>);
  s.L = (Fp12*)base;
  base += (size_t)n * sizeof(Fp12);
  s.Q = (Fp2*)base;
  base += (size_t)n * 2 * sizeof(Fp2);
  s.P = (Fp*)base;
  base += (size_t)n * 2 * sizeof(Fp);
  s.live = (uint8_t*)base;
  rlc_miller_product_kernel<<<1, threads, 0, stream>>>(
      apx, apy, a_inf, sX, sY, sZ, hx, hy, h_ok, mask, g1x, g1y, B, m, s,
      f_out, sum_out, s_inf_out);
  return cudaGetLastError();
}

int final_exp_is_one_launch(const int32_t* f, int32_t* fe, uint8_t* ok,
                            cudaStream_t stream) {
  final_exp_is_one_kernel<<<1, 1, 0, stream>>>(f, fe, ok);
  return cudaGetLastError();
}

}  // extern "C"
