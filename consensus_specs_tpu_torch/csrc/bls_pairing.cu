// Kernel K12 precomp_miller_product: the Miller product over
// host-precomputed G2 lines, the device half of `pairing_check_device`
// (its verdict is K10's, `bls_rlc.cu`).
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
// Design (a first version ran K9's first, shared-accumulator design: per
// step every lane evaluated its dense line, the block multiplied the B
// lines in a tree and thread 0 squared and multiplied the one accumulator,
// about 17,000 dependent Montgomery products at B = 8).  Now the per-lane
// body of `bls_rlc_body.cuh`, in three launches:
//   lines  one thread per line term of a live lane: the boundary limbs to
//          Montgomery form, and the x and y terms evaluated at P (cx
//          (sx xp), cy (sy yp)), into rows compacted over the live lanes.
//          Off the lanes' chain: every term at once.
//   lanes  `precomp_lanes`: one group of 6 threads per live lane, each
//          with its own accumulator; a doubling step is f^2 and the
//          product by the sparse line, 5 Fq2 products deep.  No G2
//          arithmetic.  Dead lanes start no group.
//   fold   `rlc_fold` on one block: the live lanes' values conjugated and
//          multiplied in a tree (one when no lane is live).
// What bounds it: one lane's dependent chain of 68 steps (latency).

#include <cuda_runtime.h>
#include <stdint.h>

#include "bls12_381.cuh"
#include "bls_rlc_body.cuh"

#define LINE_THREADS 128   // threads per block of the lines launch
#define X_STEPS 64         // rows of line terms reserved per lane: at most
                           // one per bit of the 64-bit |x|

namespace {

// The line term (step = blockIdx.y, lane i, slot s) of a live lane i, to
// row (step, j, s) of `out` with j its rank among the live lanes: c0 as
// given, cx times sx xp, cy times sy yp.  The add slots are filled on the
// set bits of |x| only.
__global__ void __launch_bounds__(LINE_THREADS)
precomp_lines_kernel(const int32_t* __restrict__ xp,
                     const int32_t* __restrict__ yp,
                     const int32_t* __restrict__ lines,
                     const uint8_t* __restrict__ mask, int B,
                     Fp2* __restrict__ out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  const int step = blockIdx.y, top = bls_x_top();
  if (e >= B * 6 || step >= top) return;
  const int i = e / 6, s = e % 6;
  if (!mask[i]) return;
  if (s >= 3 && !((bls_x_abs() >> (top - 1 - step)) & 1)) return;
  int j = 0;
  for (int k = 0; k < i; ++k) j += mask[k] != 0;
  Fp2 c, t;
  load_fp2(c, lines + ((int64_t)step * B * 6 + e) * 2 * BLS_NL);
  if (s % 3 != 0) {
    Fp p;
    load_fp(p, (s % 3 == 1 ? xp : yp) + i * BLS_NL);
    fp2_mul_fp(t, s % 3 == 1 ? BLS.sx : BLS.sy, p);
    fp2_mul(c, c, t);
  }
  out[((int64_t)step * B + j) * 6 + s] = c;
}

__global__ void __launch_bounds__(LANES_PER_BLOCK * LANE_G)
precomp_lanes_kernel(const Fp2* __restrict__ lines,
                     const uint8_t* __restrict__ mask, int B,
                     Fp12* __restrict__ F) {
  precomp_lanes(lines, mask, B, F);
}

__global__ void __launch_bounds__(FOLD_GROUPS * LANE_G)
precomp_fold_kernel(Fp12* __restrict__ F, const uint8_t* __restrict__ mask,
                    int B, int32_t* __restrict__ f_out) {
  const int n = count_live(mask, B);
  if (n == 0) {                             // block-uniform
    if (threadIdx.x == 0) {
      Fp12 one;
      fp12_one(one);
      store_fp12(f_out, one);
    }
    return;
  }
  rlc_fold(F, n, nullptr, 0, f_out);
}

}  // namespace

extern "C" {

int bls_set_constants(const uint32_t* words, int n_words) {
  const void* kernels[] = {(const void*)precomp_lines_kernel,
                           (const void*)precomp_lanes_kernel,
                           (const void*)precomp_fold_kernel};
  return bls_write_constants(words, n_words, kernels, 3);
}

// scratch: at least precomp_miller_scratch_bytes(B) bytes, 16-byte
// aligned: the line rows, then a row per lane for the lanes' values
int64_t precomp_miller_scratch_bytes(int B) {
  return (int64_t)X_STEPS * B * 6 * sizeof(Fp2) + (int64_t)B * sizeof(Fp12);
}

int precomp_miller_product_launch(const int32_t* xp, const int32_t* yp,
                                  const int32_t* lines, const uint8_t* mask,
                                  int B, void* scratch, int32_t* f_out,
                                  cudaStream_t stream) {
  Fp2* rows = (Fp2*)scratch;
  Fp12* F = (Fp12*)((char*)scratch + (size_t)X_STEPS * B * 6 * sizeof(Fp2));
  dim3 grid((B * 6 + LINE_THREADS - 1) / LINE_THREADS, X_STEPS);
  precomp_lines_kernel<<<grid, LINE_THREADS, 0, stream>>>(xp, yp, lines,
                                                          mask, B, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  precomp_lanes_kernel<<<(B + LANES_PER_BLOCK - 1) / LANES_PER_BLOCK,
                         LANES_PER_BLOCK * LANE_G, 0, stream>>>(rows, mask, B,
                                                                F);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  precomp_fold_kernel<<<1, FOLD_GROUPS * LANE_G, 0, stream>>>(F, mask, B,
                                                              f_out);
  return cudaGetLastError();
}

}  // extern "C"
