// Kernel K12 precomp_miller_product: the shared-accumulator Miller
// product over host-precomputed G2 lines, the device half of
// `pairing_check_device` (its verdict is K10's, `bls_rlc.cu`).
//
// Replaces pairing_jax.py:234 miller_product_precomp as
// bls_batch/__init__.py:221 _pairing_check_precomp_fn runs it (before
// :273 multi_pairing_check_precomp's final exponentiation).
//
// Inputs: xp, yp (B, 33) the G1 arguments in affine form; lines
// (n_bits, B, 6, 2, 33), per Miller step and lane the Fq2 coefficients
// [dbl c0, cx, cy, add c0, cx, cy] of `pairing.precompute_g2_lines`
// (the add slots are read on the set bits of |x| only); mask (B,).
// Output: the conjugated product, one Fq12, canonical.
//
// Design: K9's step structure without its G2 arithmetic.  One block; per
// step each thread loads its lane's coefficients, evaluates the line at
// P (`line_at`, masked lanes the identity), the block multiplies the
// lines in a tree and thread 0 squares and multiplies the accumulator
// (`bls_miller.cuh`, shared with K9).  What bounds it: the serial chain
// of each step (the tree's log2(B) Fq12 products, the square and the
// fold), about 17,000 dependent Montgomery products at B = 8: latency.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bls12_381.cuh"
#include "bls_miller.cuh"

namespace {

__global__ void __launch_bounds__(256)
precomp_miller_product_kernel(const int32_t* __restrict__ xp,
                              const int32_t* __restrict__ yp,
                              const int32_t* __restrict__ lines,
                              const uint8_t* __restrict__ mask, int B,
                              Fp12* __restrict__ L, Fp* __restrict__ P,
                              int32_t* __restrict__ f_out) {
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int i = tid; i < B; i += nt) {
    load_fp(P[2 * i], xp + i * BLS_NL);
    load_fp(P[2 * i + 1], yp + i * BLS_NL);
  }
  __syncthreads();

  Fp12 f;
  fp12_one(f);
  const uint64_t x_abs = bls_x_abs();
  const int top = bls_x_top();
  for (int bit = top - 1; bit >= 0; --bit) {
    const int step = top - 1 - bit;
    const bool add = (x_abs >> bit) & 1;
    for (int pass = 0; pass < (add ? 2 : 1); ++pass) {
      for (int i = tid; i < B; i += nt) {
        Fp12 line;
        if (mask[i]) {
          const int32_t* c =
              lines + ((int64_t)(step * B + i) * 6 + 3 * pass) * 2 * BLS_NL;
          Fp2 c0, cx, cy;
          load_fp2(c0, c);
          load_fp2(cx, c + 2 * BLS_NL);
          load_fp2(cy, c + 4 * BLS_NL);
          line_at(line, c0, cx, cy, P[2 * i], P[2 * i + 1]);
        } else {
          fp12_one(line);
        }
        L[i] = line;
      }
      miller_fold(f, L, B, pass == 0);
    }
  }
  if (tid == 0) {
    fp12_conj(f, f);                        // negative BLS parameter
    store_fp12(f_out, f);
  }
}

}  // namespace

extern "C" {

int bls_set_constants(const uint32_t* words, int n_words) {
  const void* kernels[] = {(const void*)precomp_miller_product_kernel};
  return bls_write_constants(words, n_words, kernels, 1);
}

// scratch: at least precomp_miller_scratch_bytes(B) bytes, 16-byte aligned
int64_t precomp_miller_scratch_bytes(int B) {
  return (int64_t)B * (sizeof(Fp12) + 2 * sizeof(Fp));
}

int precomp_miller_product_launch(const int32_t* xp, const int32_t* yp,
                                  const int32_t* lines, const uint8_t* mask,
                                  int B, void* scratch, int32_t* f_out,
                                  int threads, cudaStream_t stream) {
  Fp12* L = (Fp12*)scratch;
  Fp* P = (Fp*)((char*)scratch + (size_t)B * sizeof(Fp12));
  precomp_miller_product_kernel<<<1, threads, 0, stream>>>(
      xp, yp, lines, mask, B, L, P, f_out);
  return cudaGetLastError();
}

}  // extern "C"
