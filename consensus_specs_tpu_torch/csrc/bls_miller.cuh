// The shared-accumulator Miller product's block-level pieces, used by K9
// (`bls_rlc.cu` rlc_miller_product, lines computed from G2 points on the
// device) and K12 (`bls_pairing.cu` precomp_miller_product, lines from
// host-precomputed coefficients): the sparse line evaluated at P, the
// product of one step's lines over the block, and the accumulator fold
// f <- f^2 * prod_b line_b (pairing_jax.py:133 and :234).
#pragma once

#include "bls12_381.cuh"

// The line c0 + (cx xp) sx w^jx + (cy yp) sy w^jy as an Fp12: the Fq2
// coefficients of a tangent or chord evaluated at the untwist preimage
// of P = (xp, yp) (pairing_jax.py _line_to_fq12 after fq2_mul_fq).
__device__ __noinline__ void line_at(Fp12& line, const Fp2& c0, const Fp2& cx,
                                     const Fp2& cy, const Fp& xp,
                                     const Fp& yp) {
  Fp2 t;
  fp12_one(line);
  line.c0.c0 = c0;
  fp2_mul_fp(t, cx, xp);
  fp2_mul(fp12_slot(line, BLS.jx), t, BLS.sx);
  fp2_mul_fp(t, cy, yp);
  fp2_mul(fp12_slot(line, BLS.jy), t, BLS.sy);
}

// L[0] <- L[0] * ... * L[n-1], in place, by the whole block
__device__ void tree_product(Fp12* L, int n) {
  while (n > 1) {
    int h = (n + 1) / 2;
    for (int i = threadIdx.x; i < n - h; i += blockDim.x) {
      Fp12 a = L[i], b = L[i + h];
      fp12_mul(a, a, b);
      L[i] = a;
    }
    __syncthreads();
    n = h;
  }
}

// Once every thread has written its lane's line into L[0..n): thread 0
// squares the accumulator on a doubling step, the block multiplies the
// lines, and thread 0 multiplies their product into the accumulator.
__device__ void miller_fold(Fp12& f, Fp12* L, int n, bool square) {
  if (threadIdx.x == 0 && square) fp12_sqr(f, f);
  __syncthreads();
  tree_product(L, n);
  if (threadIdx.x == 0) {
    Fp12 l = L[0];
    fp12_mul(f, f, l);
  }
  __syncthreads();
}

// |x|, the BLS12-381 parameter, and the index of its top bit: the Miller
// loop runs over the bits below it, MSB first
__device__ __forceinline__ uint64_t bls_x_abs() {
  return ((uint64_t)BLS.x_abs_hi << 32) | BLS.x_abs_lo;
}
__device__ __forceinline__ int bls_x_top() {
  const uint64_t x_abs = bls_x_abs();
  int top = 63;
  while (!((x_abs >> top) & 1)) --top;
  return top;
}
