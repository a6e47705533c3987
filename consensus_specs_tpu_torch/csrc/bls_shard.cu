// Kernels K25 and K26: the sharded RLC batch verify's device work beside
// K8 and K10 (replaces bls_batch/__init__.py:711 _rlc_kernel_sharded, its
// local body at :743-776).  `batch_verify_sharded` runs K8 and K25 on each
// shard's lanes, gathers the partials to one device, then K26 and K10.
//
//   K25 rlc_miller_shard   K9's Miller body (bls_rlc_body.cuh) on the
//                          shard's B lanes without the shared (-G1, sum)
//                          lane: the conjugated Miller product and the
//                          shard's signature sum, left Jacobian
//   K26 rlc_shard_combine  one block: the D gathered G2 partials summed in
//                          pt_sum's tree and to affine with its infinity
//                          flag, the Miller loop of the one lane (-G1, sum)
//                          through the same body with the pairing lanes
//                          left out, times the product of the D Fq12
//                          partials (pairing_jax.py:318 _product_tree's
//                          product, in bls_miller.cuh's tree): f for K10,
//                          equal (canonically) to K9's f over all the
//                          lanes, since a product of Miller values does not
//                          depend on its grouping
//
// A first K26 ran that lane in its own loop after the block's fold and
// gave a wrong f on the H100 (right on a CPU build of the same source),
// with one thread or all, at any stack limit or ptxas level, and with its
// operands staged as the body stages them (ROADMAP.md, faults); through
// the shared body it is right.  The body's template flags keep
// K9's code as it was; the two kernels live in their own source so that
// nvcc compiles them beside bls_rlc.cu.  What bounds them: as K9, the
// serial chain of Fq12 products of one Miller loop (latency).
// Inputs and outputs are the port's boundary format (bls12_381.cuh);
// every launcher returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "bls12_381.cuh"
#include "bls_miller.cuh"
#include "bls_rlc_body.cuh"

namespace {

// --- K25 -------------------------------------------------------------------

__global__ void __launch_bounds__(256)
rlc_miller_shard_kernel(const int32_t* __restrict__ apx,
                        const int32_t* __restrict__ apy,
                        const uint8_t* __restrict__ a_inf,
                        const int32_t* __restrict__ sX,
                        const int32_t* __restrict__ sY,
                        const int32_t* __restrict__ sZ,
                        const int32_t* __restrict__ hx,
                        const int32_t* __restrict__ hy,
                        const uint8_t* __restrict__ h_ok,
                        const uint8_t* __restrict__ mask, int B, int m,
                        MillerScratch s, int32_t* __restrict__ f_out,
                        int32_t* __restrict__ sum_out) {
  Fp12 f = rlc_miller_body<true, false>(apx, apy, a_inf, sX, sY, sZ, hx, hy,
                                        h_ok, mask, nullptr, nullptr, B, m, s,
                                        sum_out, nullptr);
  if (threadIdx.x == 0) store_fp12(f_out, f);
}

// --- K26 -------------------------------------------------------------------

// fs: the D shards' Miller products; sX, sY, sZ: their D Jacobian
// signature sums.  parts: D rows of scratch.
__global__ void __launch_bounds__(256)
rlc_shard_combine_kernel(const int32_t* __restrict__ sX,
                         const int32_t* __restrict__ sY,
                         const int32_t* __restrict__ sZ,
                         const int32_t* __restrict__ fs,
                         const int32_t* __restrict__ g1x,
                         const int32_t* __restrict__ g1y, int D, int m,
                         MillerScratch s, Fp12* __restrict__ parts,
                         int32_t* __restrict__ f_out,
                         int32_t* __restrict__ sum_out,
                         uint8_t* __restrict__ s_inf_out) {
  for (int i = threadIdx.x; i < D; i += blockDim.x)
    load_fp12(parts[i], fs + i * 12 * BLS_NL);
  __syncthreads();
  // the shared lane (-G1, sum of the D partial sums), as K9 runs it
  Fp12 f = rlc_miller_body<false, true>(nullptr, nullptr, nullptr, sX, sY,
                                        sZ, nullptr, nullptr, nullptr,
                                        nullptr, g1x, g1y, D, m, s, sum_out,
                                        s_inf_out);
  tree_product(parts, D);
  if (threadIdx.x == 0) {
    Fp12 p = parts[0];
    fp12_mul(f, f, p);
    store_fp12(f_out, f);
  }
}

}  // namespace

extern "C" {

int bls_set_constants(const uint32_t* words, int n_words) {
  const void* kernels[] = {(const void*)rlc_miller_shard_kernel,
                           (const void*)rlc_shard_combine_kernel};
  return bls_write_constants(words, n_words, kernels, 2);
}

// scratch: at least rlc_shard_scratch_bytes(B) bytes, 16-byte aligned
int64_t rlc_shard_scratch_bytes(int B) { return rlc_scratch_bytes(B); }

// K25: the shard's Jacobian signature sum to sum_out (X, Y, Z, each an
// Fp2) and its Miller product over its B lanes to f_out
int rlc_miller_shard_launch(const int32_t* apx, const int32_t* apy,
                            const uint8_t* a_inf, const int32_t* sX,
                            const int32_t* sY, const int32_t* sZ,
                            const int32_t* hx, const int32_t* hy,
                            const uint8_t* h_ok, const uint8_t* mask, int B,
                            void* scratch, int32_t* f_out, int32_t* sum_out,
                            int threads, cudaStream_t stream) {
  int m = 1;
  while (m < B) m *= 2;
  rlc_miller_shard_kernel<<<1, threads, 0, stream>>>(
      apx, apy, a_inf, sX, sY, sZ, hx, hy, h_ok, mask, B, m,
      rlc_scratch(scratch, B, m), f_out, sum_out);
  return cudaGetLastError();
}

// K26's partials follow the Miller scratch, 16-byte aligned
static int64_t combine_parts_offset(int D) {
  return (rlc_scratch_bytes(D) + 15) / 16 * 16;
}

// scratch: at least rlc_combine_scratch_bytes(D) bytes, 16-byte aligned
int64_t rlc_combine_scratch_bytes(int D) {
  return combine_parts_offset(D) + (int64_t)D * sizeof(Fp12);
}

// K26: the D partials (sX, sY, sZ: Jacobian G2; fs: Fq12) -> f for K10,
// the affine sum and its infinity flag
int rlc_shard_combine_launch(const int32_t* sX, const int32_t* sY,
                             const int32_t* sZ, const int32_t* fs,
                             const int32_t* g1x, const int32_t* g1y, int D,
                             void* scratch, int32_t* f_out, int32_t* sum_out,
                             uint8_t* s_inf_out, cudaStream_t stream) {
  int m = 1;
  while (m < D) m *= 2;
  Fp12* parts = (Fp12*)((char*)scratch + combine_parts_offset(D));
  int threads = ((m + 31) / 32) * 32;
  if (threads > 256) threads = 256;
  rlc_shard_combine_kernel<<<1, threads, 0, stream>>>(
      sX, sY, sZ, fs, g1x, g1y, D, m, rlc_scratch(scratch, D, m), parts,
      f_out, sum_out, s_inf_out);
  return cudaGetLastError();
}

}  // extern "C"
