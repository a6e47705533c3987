// Kernels K25 and K26: the sharded RLC batch verify's device work beside
// K8 and K10 (replaces bls_batch/__init__.py:711 _rlc_kernel_sharded, its
// local body at :743-776).  `batch_verify_sharded` runs K8 and K25 on each
// shard's lanes, gathers the partials to one device, then K26 and K10.
//
//   K25 rlc_miller_shard   K9's lanes and fold (bls_rlc_body.cuh) on the
//                          shard's B lanes without the shared (-G1, sum)
//                          lane: the conjugated Miller product and the
//                          shard's signature sum, left Jacobian
//   K26 rlc_shard_combine  the D gathered G2 partials summed in pt_sum's
//                          tree and to affine with its infinity flag, the
//                          Miller loop of the one lane (-G1, sum) through
//                          the same per-lane code as K9's lanes, then the
//                          fold of its value with the D Fq12 partials: f
//                          for K10, equal (canonically) to K9's f over all
//                          the lanes, since a product of Miller values
//                          does not depend on its grouping
//
// A first K26 ran the shared lane in a loop of its own and gave a wrong f
// on the H100 (right on a CPU build of the same source; ROADMAP.md,
// faults); every lane, the shared one too, runs `rlc_lanes`.  The kernels
// live in their own source so that nvcc compiles them beside bls_rlc.cu.
// What bounds them: as K9, one lane's chain of 68 Miller steps (latency).
// Inputs and outputs are the port's boundary format (bls12_381.cuh);
// every launcher returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "bls12_381.cuh"
#include "bls_rlc_body.cuh"

namespace {

// --- K25 -------------------------------------------------------------------

__global__ void __launch_bounds__(LANES_PER_BLOCK * LANE_G)
rlc_shard_lanes_kernel(const int32_t* __restrict__ apx,
                       const int32_t* __restrict__ apy,
                       const uint8_t* __restrict__ a_inf,
                       const int32_t* __restrict__ sX,
                       const int32_t* __restrict__ sY,
                       const int32_t* __restrict__ sZ,
                       const int32_t* __restrict__ hx,
                       const int32_t* __restrict__ hy,
                       const uint8_t* __restrict__ h_ok,
                       const uint8_t* __restrict__ mask, int B, int m,
                       Jac<Fp2>* __restrict__ sums, Fp12* __restrict__ F,
                       int32_t* __restrict__ sum_out) {
  rlc_lanes<true, false>(apx, apy, a_inf, sX, sY, sZ, hx, hy, h_ok, mask,
                         nullptr, nullptr, B, m, sums, F, sum_out, nullptr);
}

// --- K26 -------------------------------------------------------------------

// sX, sY, sZ: the D shards' Jacobian signature sums
__global__ void __launch_bounds__(LANES_PER_BLOCK * LANE_G)
rlc_combine_lane_kernel(const int32_t* __restrict__ sX,
                        const int32_t* __restrict__ sY,
                        const int32_t* __restrict__ sZ,
                        const int32_t* __restrict__ g1x,
                        const int32_t* __restrict__ g1y, int D, int m,
                        Jac<Fp2>* __restrict__ sums, Fp12* __restrict__ F,
                        int32_t* __restrict__ sum_out,
                        uint8_t* __restrict__ s_inf_out) {
  rlc_lanes<false, true>(nullptr, nullptr, nullptr, sX, sY, sZ, nullptr,
                         nullptr, nullptr, nullptr, g1x, g1y, D, m, sums, F,
                         sum_out, s_inf_out);
}

__global__ void __launch_bounds__(FOLD_GROUPS * LANE_G)
rlc_fold_kernel(Fp12* __restrict__ F, int n_raw,
                const int32_t* __restrict__ extra, int n_extra,
                int32_t* __restrict__ f_out) {
  rlc_fold(F, n_raw, extra, n_extra, f_out);
}

}  // namespace

extern "C" {

int bls_set_constants(const uint32_t* words, int n_words) {
  const void* kernels[] = {(const void*)rlc_shard_lanes_kernel,
                           (const void*)rlc_combine_lane_kernel,
                           (const void*)rlc_fold_kernel};
  return bls_write_constants(words, n_words, kernels, 3);
}

// scratch: at least rlc_shard_scratch_bytes(B) bytes, 16-byte aligned
int64_t rlc_shard_scratch_bytes(int B) { return rlc_scratch_bytes(B, B); }

// K25: the shard's Jacobian signature sum to sum_out (X, Y, Z, each an
// Fp2) and its Miller product over its B lanes to f_out
int rlc_miller_shard_launch(const int32_t* apx, const int32_t* apy,
                            const uint8_t* a_inf, const int32_t* sX,
                            const int32_t* sY, const int32_t* sZ,
                            const int32_t* hx, const int32_t* hy,
                            const uint8_t* h_ok, const uint8_t* mask, int B,
                            void* scratch, int32_t* f_out, int32_t* sum_out,
                            cudaStream_t stream) {
  Fp12* F = rlc_scratch_rows(scratch, B);
  rlc_shard_lanes_kernel<<<rlc_lane_blocks(B), LANES_PER_BLOCK * LANE_G, 0,
                           stream>>>(apx, apy, a_inf, sX, sY, sZ, hx, hy,
                                     h_ok, mask, B, sum_rows(B),
                                     (Jac<Fp2>*)scratch, F, sum_out);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rlc_fold_kernel<<<1, FOLD_GROUPS * LANE_G, 0, stream>>>(F, B, nullptr, 0,
                                                          f_out);
  return cudaGetLastError();
}

// scratch: at least rlc_combine_scratch_bytes(D) bytes, 16-byte aligned
int64_t rlc_combine_scratch_bytes(int D) {
  return rlc_scratch_bytes(D, 1 + D);
}

// K26: the D partials (sX, sY, sZ: Jacobian G2; fs: Fq12) -> f for K10,
// the affine sum and its infinity flag
int rlc_shard_combine_launch(const int32_t* sX, const int32_t* sY,
                             const int32_t* sZ, const int32_t* fs,
                             const int32_t* g1x, const int32_t* g1y, int D,
                             void* scratch, int32_t* f_out, int32_t* sum_out,
                             uint8_t* s_inf_out, cudaStream_t stream) {
  Fp12* F = rlc_scratch_rows(scratch, D);
  rlc_combine_lane_kernel<<<1, LANES_PER_BLOCK * LANE_G, 0, stream>>>(
      sX, sY, sZ, g1x, g1y, D, sum_rows(D), (Jac<Fp2>*)scratch, F, sum_out,
      s_inf_out);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rlc_fold_kernel<<<1, FOLD_GROUPS * LANE_G, 0, stream>>>(F, 1, fs, D, f_out);
  return cudaGetLastError();
}

}  // extern "C"
