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
//                          by 128-bit MSB-first double-and-add on the
//                          group point passes (its section below)
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
//                          cube of the standard pairing value), with
//                          :279 fq12_pow_x_abs, and tower.py fq12_is_one
//
// Inputs and outputs are the port's boundary format (bls12_381.cuh):
// (..., 33) int32 limbs, R = 2^396; outputs are canonical.
//
// Design: the work is a chain of dependent Montgomery
// products per lane, and one batch has only B + 1 = 129 lanes, far less
// than one wave of the card, so every kernel is latency-bound, not
// issue-bound.  K8 runs a group of threads per lane and group, one lane a
// warp (its section below).  K9 (`bls_rlc_body.cuh`, shared
// with K25 and K26) is two launches: a group of 6 threads per lane, each
// lane with its own Miller accumulator, the lanes spread over
// ceil(B / 5) + 1 blocks (block 0 sums the signature rows and runs the
// shared lane), then one block multiplies the lanes' values in a tree.
// K10 is one group of FE_G = 18 threads (its section below).
// Every launcher returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "bls12_381.cuh"
#include "bls_rlc_body.cuh"

namespace {

enum FieldOp {
  OP_FQ_MUL = 0, OP_FQ_INV, OP_FQ_CANON, OP_FQ2_MUL, OP_FQ2_INV,
  OP_FQ12_MUL, OP_FQ12_SQR, OP_FQ12_INV, OP_FQ12_FROBENIUS, OP_FQ_ADD,
  OP_FQ_SUB
};

// --- K7 --------------------------------------------------------------------

__global__ void __launch_bounds__(64)
bls_field_ops_kernel(int op, int k, const int32_t* __restrict__ a,
                     const int32_t* __restrict__ b, int32_t* __restrict__ out,
                     int64_t n) {
  int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  if (op <= OP_FQ_CANON || op >= OP_FQ_ADD) {
    Fp x, y;
    load_fp(x, a + e * BLS_NL);
    if (op == OP_FQ_MUL || op >= OP_FQ_ADD) load_fp(y, b + e * BLS_NL);
    if (op == OP_FQ_MUL) {
      fp_mul(x, x, y);
    } else if (op == OP_FQ_INV) {
      fp_inv(x, x);
    } else if (op == OP_FQ_ADD) {
      fp_add(x, x, y);
    } else if (op == OP_FQ_SUB) {
      fp_sub(x, x, y);
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
//
// One warp per lane: a G2 lane on K8_G2_RANKS = 9 of its threads, each
// Fq2 product of a round split into its three Karatsuba Fp products
// (a0 b0, a1 b1, (a0 + a1)(b0 + b1)) on three ranks, so a round is one Fp
// product deep; a G1 lane on 3 threads, one Fp product a rank.  Both run
// the group point passes of `bls_point_passes.cuh` (shared with the Miller
// body) over r's bits, MSB first: a doubling (3 rounds) per bit, an
// addition of the affine base (6 rounds) per set bit, in place of the
// serial dbl-2007-bl and the general add-2007-bl.  A lane's rounds meet
// at warp barriers, so lanes whose bits differ never wait for each other.
// Warps that share an SM slow each other, so the launcher gives each warp
// an SM of its own where the card has 2B SMs (2B one-warp blocks: the
// G2 lanes, then the G1 lanes), and otherwise puts lane i's G2 and G1
// warps in block i (on an H100: 4.41 against 4.95 ms at B = 32, 6.65
// against 6.95 at B = 128).  The G1 lane ends in affine form through the
// binary inversion (`mont_inv_binary`), 0 -> (0, 0) with a_inf set.

#define K8_G2_RANKS 9          // 3 Fq2 products x 3 Karatsuba parts
#define K8_G1_RANKS 3          // 3 Fp products

template <class F> struct K8Lane {
  GroupPoint<F> P;
  Fp part[3][3];               // a round's Karatsuba parts (G2)
};

// One copy of the Fp product and of each pass's operand picks, called
// from every round: inlined at each call site they made the chain's code
// far larger than the instruction cache (on an H100, K8 at B = 128 took
// 8.5 ms so, 6.7 with these calls).
__device__ __noinline__ void k8_mul(Fp& out, const Fp& a, const Fp& b) {
  fp_mul(out, a, b);
}

template <class F, bool kDbl>
__device__ __noinline__ F* k8_operands(GroupPoint<F>& P, int k, int j, F& a,
                                       F& b) {
  return kDbl ? pt_dbl_operands(P, k, j, a, b)
              : pt_add_operands(P, k, j, a, b);
}

// round k of a pass on the lane's ranks: product j = r / kSplit of the
// round, whole (kSplit = 1) or its Karatsuba part r % 3 (kSplit = 3, F =
// Fp2), after which ranks 3j and 3j + 1 form its c0 and c1.  Every thread
// of the warp calls it.
template <class F, int kSplit, bool kDbl>
__device__ __forceinline__ void k8_round(K8Lane<F>& S, int k, int r,
                                         bool live) {
  const int j = r / kSplit, h = r % kSplit;
  const int n = kDbl ? pt_dbl_products(k) : pt_add_products(k);
  F* out = nullptr;
  if (live && j < n) {
    F a, b;
    out = k8_operands<F, kDbl>(S.P, k, j, a, b);
    if constexpr (kSplit == 1) {
      k8_mul(*out, a, b);
    } else {
      Fp x, y;
      if (h == 0) {
        x = a.c0;
        y = b.c0;
      } else if (h == 1) {
        x = a.c1;
        y = b.c1;
      } else {
        fp_add(x, a.c0, a.c1);
        fp_add(y, b.c0, b.c1);
      }
      k8_mul(S.part[j][h], x, y);
    }
  }
  __syncwarp();
  if constexpr (kSplit == 3) {
    if (out && h == 0) {                    // c0 = a0 b0 - a1 b1
      fp_sub(out->c0, S.part[j][0], S.part[j][1]);
    } else if (out && h == 1) {             // c1 = (a0 + a1)(b0 + b1) - ...
      Fp u;
      fp_add(u, S.part[j][0], S.part[j][1]);
      fp_sub(out->c1, S.part[j][2], u);
    }
    __syncwarp();
  }
}

// T <- r T by double-and-add over r's nbits bits, MSB first, from T at
// infinity; every thread of the warp calls it
template <class F, int kSplit>
__device__ __forceinline__ void k8_chain(K8Lane<F>& S,
                                         const int32_t* __restrict__ bits,
                                         int nbits, int r, bool rank) {
  for (int i = 0; i < nbits; ++i) {
#pragma unroll 1
    for (int k = 0; k < PT_DBL_ROUNDS; ++k)
      k8_round<F, kSplit, true>(S, k, r, rank);
    if (rank && r == 0) pt_dbl_finish(S.P);
    __syncwarp();
    if (bits[i]) {                          // warp-uniform
#pragma unroll 1
      for (int k = 0; k < PT_ADD_ROUNDS; ++k)
        k8_round<F, kSplit, false>(S, k, r, rank);
      if (rank && r == 0) pt_add_finish(S.P);
      __syncwarp();
    }
  }
}

// r S for lane `lane` (G2, Jacobian; a pad lane at infinity), on its warp
__device__ __forceinline__ void k8_g2_lane(
    K8Lane<Fp2>& S, int lane, int r, const int32_t* __restrict__ sig_x,
    const int32_t* __restrict__ sig_y, const int32_t* __restrict__ bits,
    const uint8_t* __restrict__ mask, int nbits, int32_t* __restrict__ sX,
    int32_t* __restrict__ sY, int32_t* __restrict__ sZ) {
  if (r < 4) {                              // xq.c0, xq.c1, yq.c0, yq.c1
    const int32_t* src = (r < 2 ? sig_x : sig_y) + lane * 2 * BLS_NL;
    load_fp(((Fp*)&S.P.xq)[r], src + (r & 1) * BLS_NL);
  } else if (r == 4) {
    pt_set_infinity(S.P);
  }
  __syncwarp();
  k8_chain<Fp2, 3>(S, bits + (int64_t)lane * nbits, nbits, r,
                   r < K8_G2_RANKS);
  if (r == 0 && !mask[lane]) pt_set_infinity(S.P);  // pad lanes leave the sum
  __syncwarp();
  if (r < 6) {                              // X, Y, Z: c0, c1 each
    int32_t* dst = (r < 2 ? sX : (r < 4 ? sY : sZ)) + lane * 2 * BLS_NL;
    store_fp(dst + (r & 1) * BLS_NL, ((Fp*)&S.P.X)[r]);
  }
}

// r PK for lane `lane` (G1), to affine with its infinity flag, on its warp
__device__ __forceinline__ void k8_g1_lane(
    K8Lane<Fp>& S, int lane, int r, const int32_t* __restrict__ pk_x,
    const int32_t* __restrict__ pk_y, const int32_t* __restrict__ bits,
    int nbits, int32_t* __restrict__ apx, int32_t* __restrict__ apy,
    uint8_t* __restrict__ a_inf) {
  if (r == 0) load_fp(S.P.xq, pk_x + lane * BLS_NL);
  else if (r == 1) load_fp(S.P.yq, pk_y + lane * BLS_NL);
  else if (r == 2) pt_set_infinity(S.P);
  __syncwarp();
  k8_chain<Fp, 1>(S, bits + (int64_t)lane * nbits, nbits, r,
                  r < K8_G1_RANKS);
  if (r == 0) {                             // (X / Z^2, Y / Z^3); 0 -> 0
    Fp zi, zi2, u;
    fp_inv_binary(zi, S.P.Z);
    fp_sqr(zi2, zi);
    fp_mul(S.P.t[0], S.P.X, zi2);
    fp_mul(u, zi2, zi);
    fp_mul(S.P.t[1], S.P.Y, u);
  }
  __syncwarp();
  if (r == 0) store_fp(apx + lane * BLS_NL, S.P.t[0]);
  else if (r == 1) store_fp(apy + lane * BLS_NL, S.P.t[1]);
  else if (r == 2) a_inf[lane] = fp_is_zero(S.P.Z);
}

// blockDim 32: blocks [0, B) the G2 lanes, [B, 2B) the G1 lanes;
// blockDim 64: block i lane i's G2 warp, then its G1 warp
__global__ void __launch_bounds__(64)
rlc_scalar_mul_kernel(const int32_t* __restrict__ pk_x,
                      const int32_t* __restrict__ pk_y,
                      const int32_t* __restrict__ sig_x,
                      const int32_t* __restrict__ sig_y,
                      const int32_t* __restrict__ bits,
                      const uint8_t* __restrict__ mask, int nbits, int B,
                      int32_t* __restrict__ apx, int32_t* __restrict__ apy,
                      uint8_t* __restrict__ a_inf, int32_t* __restrict__ sX,
                      int32_t* __restrict__ sY, int32_t* __restrict__ sZ) {
  __shared__ K8Lane<Fp2> s2;
  __shared__ K8Lane<Fp> s1;
  const int r = threadIdx.x % 32, b = blockIdx.x;
  const bool pair = blockDim.x == 64;
  const bool g2 = pair ? threadIdx.x < 32 : b < B;
  const int lane = pair || g2 ? b : b - B;
  if (g2) k8_g2_lane(s2, lane, r, sig_x, sig_y, bits, mask, nbits, sX, sY,
                     sZ);
  else k8_g1_lane(s1, lane, r, pk_x, pk_y, bits, nbits, apx, apy, a_inf);
}

// --- K9 --------------------------------------------------------------------

__global__ void __launch_bounds__(LANES_PER_BLOCK * LANE_G)
rlc_miller_lanes_kernel(const int32_t* __restrict__ apx,
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
                        Jac<Fp2>* __restrict__ sums, Fp12* __restrict__ F,
                        int32_t* __restrict__ sum_out,
                        uint8_t* __restrict__ s_inf_out) {
  rlc_lanes<true, true>(apx, apy, a_inf, sX, sY, sZ, hx, hy, h_ok, mask, g1x,
                        g1y, B, m, sums, F, sum_out, s_inf_out);
}

__global__ void __launch_bounds__(FOLD_GROUPS * LANE_G)
rlc_fold_kernel(Fp12* __restrict__ F, int n_raw,
                const int32_t* __restrict__ extra, int n_extra,
                int32_t* __restrict__ f_out) {
  rlc_fold(F, n_raw, extra, n_extra, f_out);
}

// --- K10 -------------------------------------------------------------------
//
// One block of FE_G = 18 threads: 18 is the number of independent Fq2
// products of a dense Fq12 product (fp12_mul's Karatsuba) and of Fp
// products of a cyclotomic square (nine Fq2 squares of two each), so each
// of the chain's products and squares is one round of the group, a
// product one Fq2 product deep and a square one Fp product deep.  Values
// live in shared memory as 6 Fq2 in `Fp12` order; every rank calls the
// same product on operands it picks by rank (a converged warp).
//   easy part  f^((q^6 - 1)(q^2 + 1)) = frob(conj(f) / f, 2) conj(f) / f:
//              fp12_inv's Fq6 products over the group; its one Fp
//              inversion, the only serial stretch, by the sliding window
//              over p - 2's digits (`fp_pow_window`), about 450 products
//              in place of mont_pow's 570; 0 -> 0.
//   hard part  the x-structured chain of pairing_jax.py:297.  Every value
//              in it lies in the cyclotomic subgroup (for f = 0 every
//              value is 0), so it squares by Granger-Scott's cyclotomic
//              squaring (three Fq4 squares); each power by |x| starts at g
//              on |x|'s top bit: 63 squares and 5 products.
// What bounds it: the dependent chain, about 315 cyclotomic squares, 32
// dense products and the inversion (latency).

#define FE_G 18   // K10's threads

// out = a b (Fq12, 6 Fq2 each); out may be a or b
__device__ __forceinline__ void fe_mul(Fp2* out, const Fp2* a, const Fp2* b,
                                       Fp2* prod, int r) {
  fp12_mul_job(prod, a, b, r);
  __syncthreads();
  if (r < 6) fp12_mul_combine(out, prod, r);
  __syncthreads();
}

// out = a^2 for a in the cyclotomic subgroup (or 0), Granger-Scott: with
// the Fq4 squares (x, y)^2 = (x^2 + xi y^2, (x + y)^2 - x^2 - y^2) of
// t0 = (a[0], a[4]), t1 = (a[3], a[2]), t2 = (a[1], a[5]) (Fp12 order),
// out[k] = 3 A_k - 2 a[k] for k < 3 with A = (t0, t1, t2)'s first halves,
// and out[3, 4, 5] = 3 (xi t2', t0', t1') + 2 a[3, 4, 5] with their
// second halves.  Round one: rank r takes the Fp product r of the nine
// Fq2 squares x^2, y^2, (x + y)^2 (c0 = (z0 + z1)(z0 - z1), c1 = 2 z0 z1);
// round two: rank k < 6 forms out[k].  out may be a.
__device__ __noinline__ void fe_cyc_sqr(Fp2* out, const Fp2* a, Fp2* sq,
                                        int r) {
  {
    const int j = r >> 1, pair = j / 3, which = j % 3, part = r & 1;
    const int ix = pair == 0 ? 0 : (pair == 1 ? 3 : 1);
    const int iy = pair == 0 ? 4 : (pair == 1 ? 2 : 5);
    Fp2 z;
    if (which == 0) z = a[ix];
    else if (which == 1) z = a[iy];
    else fp2_add(z, a[ix], a[iy]);
    Fp u, v, o;
    if (part == 0) {
      fp_add(u, z.c0, z.c1);
      fp_sub(v, z.c0, z.c1);
    } else {
      u = z.c0;
      v = z.c1;
    }
    fp_mul(o, u, v);
    if (part) fp_dbl(o, o);
    if (part) sq[j].c1 = o;
    else sq[j].c0 = o;
  }
  __syncthreads();
  if (r < 6) {
    // sq[3p + 0] = x^2, sq[3p + 1] = y^2, sq[3p + 2] = (x + y)^2
    const int pair = r == 0 || r == 4 ? 0 : (r == 1 || r == 5 ? 1 : 2);
    const Fp2* t = sq + 3 * pair;
    Fp2 h, w;
    if (r < 3) {                            // x^2 + xi y^2
      fp2_mul_xi(h, t[1]);
      fp2_add(h, t[0], h);
      fp2_sub(w, h, a[r]);
    } else {                                // (x + y)^2 - x^2 - y^2
      fp2_sub(h, t[2], t[0]);
      fp2_sub(h, h, t[1]);
      if (r == 3) fp2_mul_xi(h, h);
      fp2_add(w, h, a[r]);
    }
    fp2_dbl(w, w);
    fp2_add(out[r], w, h);
  }
  __syncthreads();
}

// out = a^(q^k): coefficient of w^r conjugated and scaled by gamma_r, k
// times (fp12_frobenius), on ranks 0-5; out may be a
__device__ __forceinline__ void fe_frob(Fp2* out, const Fp2* a, int k,
                                       int r) {
  if (r < 6) {
    const int c = wslot(r);
    Fp2 x = a[c];
    for (int n = 0; n < k; ++n) {
      fp2_conj(x, x);
      fp2_mul(x, x, BLS.gamma[r]);
    }
    out[c] = x;
  }
  __syncthreads();
}

// out = conj(a); out may be a
__device__ __forceinline__ void fe_conj(Fp2* out, const Fp2* a, int r) {
  if (r < 3) out[r] = a[r];
  else if (r < 6) fp2_neg(out[r], a[r]);
  __syncthreads();
}

struct FeInv {
  Fp2 n[3];     // a0^2 - v a1^2, the Fq6 to invert
  Fp2 q[6];     // products
  Fp2 t[3];     // fp6_inv's t0, t1, t2
  Fp2 d;        // 1 / its norm
  Fp2 i6[3];    // 1 / n
};

// out = 1 / a (fp12_inv's formulas: 1 / (a0 + a1 w) = (a0 - a1 w) /
// (a0^2 - v a1^2), the Fq6 inverse by fp6_inv's); 0 -> 0; out may be a
__device__ __noinline__ void fe_inv(Fp2* out, const Fp2* a, Fp2* prod,
                                    FeInv& V, int r) {
  Fp2 x, y;
  if (r < 12) {                             // a0^2, a1^2: Karatsuba
    kara_operand(x, a + 3 * (r / 6), r % 6);
    fp2_mul(prod[r], x, x);
  }
  __syncthreads();
  if (r < 3) {                              // n = a0^2 - v a1^2
    kara_coeff(x, prod, r);
    kara_coeff(y, prod + 6, (r + 2) % 3);
    if (r == 0) fp2_mul_xi(y, y);
    fp2_sub(V.n[r], x, y);
  }
  __syncthreads();
  if (r < 6) {                              // n0^2, n1 n2, n2^2, n0 n1,
    const int ia[6] = {0, 1, 2, 0, 1, 0};   // n1^2, n0 n2
    const int ib[6] = {0, 2, 2, 1, 1, 2};
    fp2_mul(V.q[r], V.n[ia[r]], V.n[ib[r]]);
  }
  __syncthreads();
  if (r < 3) {                              // t0 = n0^2 - xi n1 n2,
    if (r == 0) {                           // t1 = xi n2^2 - n0 n1,
      fp2_mul_xi(x, V.q[1]);                // t2 = n1^2 - n0 n2
      fp2_sub(V.t[0], V.q[0], x);
    } else if (r == 1) {
      fp2_mul_xi(x, V.q[2]);
      fp2_sub(V.t[1], x, V.q[3]);
    } else {
      fp2_sub(V.t[2], V.q[4], V.q[5]);
    }
  }
  __syncthreads();
  if (r < 3) {                              // n2 t1, n1 t2, n0 t0
    fp2_mul(V.q[r], V.n[2 - r], V.t[r == 2 ? 0 : r + 1]);
  }
  __syncthreads();
  if (r == 0) {                             // 1 / (n0 t0 + xi (n2 t1 + n1 t2))
    fp2_add(x, V.q[0], V.q[1]);
    fp2_mul_xi(x, x);
    fp2_add(x, x, V.q[2]);
    fp2_inv_window(V.d, x, BLS.e_inv, BLS.e_inv_len);
  }
  __syncthreads();
  if (r < 3) fp2_mul(V.i6[r], V.t[r], V.d);
  __syncthreads();
  if (r < 12) {                             // a0 / n, a1 / n: Karatsuba
    kara_operand(x, a + 3 * (r / 6), r % 6);
    kara_operand(y, V.i6, r % 6);
    fp2_mul(prod[r], x, y);
  }
  __syncthreads();
  if (r < 3) kara_coeff(out[r], prod, r);
  else if (r < 6) {
    kara_coeff(x, prod + 6, r - 3);
    fp2_neg(out[r], x);
  }
  __syncthreads();
}

// out = g^x = conj(g^|x|), g^|x| from g on |x|'s top bit: a cyclotomic
// square per lower bit, a product by g per set one.  acc is scratch;
// out may be g.
__device__ __noinline__ void fe_pow_x(Fp2* out, const Fp2* g, Fp2* acc,
                                      Fp2* prod, int r) {
  if (r < 6) acc[r] = g[r];
  __syncthreads();
  const uint64_t x_abs = bls_x_abs();
  for (int bit = bls_x_top() - 1; bit >= 0; --bit) {
    fe_cyc_sqr(acc, acc, prod, r);
    if ((x_abs >> bit) & 1) fe_mul(acc, acc, g, prod, r);
  }
  fe_conj(out, acc, r);
}

__global__ void __launch_bounds__(FE_G)
final_exp_is_one_kernel(const int32_t* __restrict__ f_in,
                        int32_t* __restrict__ fe_out,
                        uint8_t* __restrict__ ok) {
  __shared__ Fp12 buf[8];
  __shared__ Fp2 prod[FE_G];
  __shared__ FeInv V;
  Fp2* f = (Fp2*)&buf[0];
  Fp2* m = (Fp2*)&buf[1];
  Fp2* t = (Fp2*)&buf[2];
  Fp2* u = (Fp2*)&buf[3];
  Fp2* t1 = (Fp2*)&buf[4];
  Fp2* t2 = (Fp2*)&buf[5];
  Fp2* t3 = (Fp2*)&buf[6];
  Fp2* acc = (Fp2*)&buf[7];
  const int r = threadIdx.x;
  if (r < 6) load_fp2(f[r], f_in + r * 2 * BLS_NL);
  __syncthreads();
  // easy part: f^((q^6 - 1)(q^2 + 1))
  fe_inv(u, f, prod, V, r);
  fe_conj(t, f, r);
  fe_mul(f, t, u, prod, r);                 // f1 = conj(f) / f
  fe_frob(t, f, 2, r);
  fe_mul(m, t, f, prod, r);
  // t1 = m^((x - 1)^2): pow_xm1(g) = g^x conj(g), twice
  fe_pow_x(t, m, acc, prod, r);
  fe_conj(u, m, r);
  fe_mul(t, t, u, prod, r);
  fe_pow_x(t1, t, acc, prod, r);
  fe_conj(u, t, r);
  fe_mul(t1, t1, u, prod, r);
  // t2 = t1^x frob(t1, 1)
  fe_pow_x(t2, t1, acc, prod, r);
  fe_frob(u, t1, 1, r);
  fe_mul(t2, t2, u, prod, r);
  // t3 = (t2^x)^x frob(t2, 2) conj(t2)
  fe_pow_x(t3, t2, acc, prod, r);
  fe_pow_x(t3, t3, acc, prod, r);
  fe_frob(u, t2, 2, r);
  fe_mul(t3, t3, u, prod, r);
  fe_conj(u, t2, r);
  fe_mul(t3, t3, u, prod, r);
  // result = t3 m^3
  fe_cyc_sqr(u, m, prod, r);
  fe_mul(u, u, m, prod, r);
  fe_mul(t3, t3, u, prod, r);
  if (r < 6) store_fp2(fe_out + r * 2 * BLS_NL, t3[r]);
  if (r == 0) *ok = fp12_is_one(buf[6]);
}

}  // namespace

extern "C" {

int bls_set_constants(const uint32_t* words, int n_words) {
  const void* kernels[] = {(const void*)bls_field_ops_kernel,
                           (const void*)rlc_scalar_mul_kernel,
                           (const void*)rlc_miller_lanes_kernel,
                           (const void*)rlc_fold_kernel,
                           (const void*)final_exp_is_one_kernel};
  return bls_write_constants(words, n_words, kernels, 5);
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
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const bool pair = 2 * B > sms;
  rlc_scalar_mul_kernel<<<pair ? B : 2 * B, pair ? 64 : 32, 0, stream>>>(
      pk_x, pk_y, sig_x, sig_y, bits, mask, nbits, B, apx, apy, a_inf, sX,
      sY, sZ);
  return cudaGetLastError();
}

// scratch: at least rlc_miller_scratch_bytes(B) bytes, 16-byte aligned
int64_t rlc_miller_scratch_bytes(int B) { return rlc_scratch_bytes(B, B + 1); }

// K9: the lanes (B pairing lanes and the shared lane), then the fold
int rlc_miller_product_launch(
    const int32_t* apx, const int32_t* apy, const uint8_t* a_inf,
    const int32_t* sX, const int32_t* sY, const int32_t* sZ,
    const int32_t* hx, const int32_t* hy, const uint8_t* h_ok,
    const uint8_t* mask, const int32_t* g1x, const int32_t* g1y, int B,
    void* scratch, int32_t* f_out, int32_t* sum_out, uint8_t* s_inf_out,
    cudaStream_t stream) {
  Fp12* F = rlc_scratch_rows(scratch, B);
  rlc_miller_lanes_kernel<<<rlc_lane_blocks(B), LANES_PER_BLOCK * LANE_G, 0,
                            stream>>>(
      apx, apy, a_inf, sX, sY, sZ, hx, hy, h_ok, mask, g1x, g1y, B,
      sum_rows(B), (Jac<Fp2>*)scratch, F, sum_out, s_inf_out);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rlc_fold_kernel<<<1, FOLD_GROUPS * LANE_G, 0, stream>>>(F, B + 1, nullptr,
                                                          0, f_out);
  return cudaGetLastError();
}

int final_exp_is_one_launch(const int32_t* f, int32_t* fe, uint8_t* ok,
                            cudaStream_t stream) {
  final_exp_is_one_kernel<<<1, FE_G, 0, stream>>>(f, fe, ok);
  return cudaGetLastError();
}

}  // extern "C"
