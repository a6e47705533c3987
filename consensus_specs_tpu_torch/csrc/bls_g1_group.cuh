// The G1 group lane: one point T (Jacobian, Fp) on a group of G1_RANKS
// threads, eight groups a warp, driven by the group point passes of
// `bls_point_passes.cuh` (the doubling and the general addition
// T <- T + Q, Q Jacobian).  K19 and K20 (`g1_fft.cu`) and K13, K14 and
// K27 (`bls_msm.cu`) run their chains on it.
//
// A round is one product deep: every rank of the warp calls the one
// non-inlined copy of the Fp product (`g1_product`) on the operands it
// picks by its pass, its round and its rank, so the warp stays converged
// whatever pass each group is in, and the chains' code stays inside the
// instruction cache.  Rounds meet at warp barriers.  No pass runs on a
// point at infinity, whose coordinates nobody reads: a doubling of T at
// infinity leaves it so, and an addition where T or Q is at infinity is
// its finish alone (it gives Q or keeps T, as pt_add does).  Every point
// and temporary of a group lives in shared memory.
#pragma once

#include "bls12_381.cuh"
#include "bls_point_passes.cuh"

#define G1_RANKS PT_GADD_WIDTH        // a group: the widest round
#define G1_WARP_LANES (32 / G1_RANKS)
#define G1_MAX_WARPS 4      // warps of a block of independent lanes
#define JAC_WORDS (3 * BLS_NW)

namespace {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void load_jac(Jac<Fp>& p, const int32_t* x,
                                         const int32_t* y, const int32_t* z) {
  load_fp(p.x, x);
  load_fp(p.y, y);
  load_fp(p.z, z);
}

// Product j of round k of a doubling (dbl) or a general addition of Q:
// its operands picked by rank, then the library's one copy of the Fp
// product.  Every rank of a round calls it, so the warp runs one
// product per round.
__device__ __noinline__ void g1_product(GroupJac<Fp>* P, const Jac<Fp>* Q,
                                        bool dbl, int k, int j) {
  Fp a, b, r;
  Fp* out = dbl ? pt_dbl_operands(*P, k, j, a, b)
                : pt_gadd_operands(*P, *Q, k, j, a, b);
  fp_mul(r, a, b);
  *out = r;
}

// copy a point (36 words) over the group's ranks; the caller syncs
__device__ __forceinline__ void copy_pt(void* dst, const void* src, int r) {
  const uint32_t* s = (const uint32_t*)src;
  uint32_t* d = (uint32_t*)dst;
  for (int i = r; i < JAC_WORDS; i += G1_RANKS) d[i] = s[i];
}

__device__ __forceinline__ void set_infinity(GroupJac<Fp>& P, int r) {
  if (r == 0) pt_set_infinity(P);
}

// rank 0 of the caller's group, as a lane of its warp
__device__ __forceinline__ int group_base() {
  return (threadIdx.x & 31) & ~(G1_RANKS - 1);
}

__device__ __forceinline__ int warp_min(int v) {
  for (int o = 16; o; o >>= 1) v = min(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ int warp_max(int v) {
  for (int o = 16; o; o >>= 1) v = max(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// T <- 2T on each live lane of the warp, rank r of its group; every
// thread of the warp calls it.  A T at infinity is left as it is.
__device__ void g1_dbl(GroupJac<Fp>& P, int r, bool live) {
  live = live && !fp_is_zero(P.Z);
  if (!__any_sync(kFull, live)) return;
  for (int k = 0; k < PT_DBL_ROUNDS; ++k) {
    if (live && r < pt_dbl_products(k)) g1_product(&P, nullptr, true, k, r);
    __syncwarp();
  }
  if (live && r == 0) pt_dbl_finish(P);
  __syncwarp();
}

// T <- T + Q (pt_add) on each live lane of the warp: the rounds where T
// and Q are both finite, the finish with pt_add's cases, and a doubling
// pass where T = Q; every thread of the warp calls it
__device__ void g1_add(GroupJac<Fp>& P, const Jac<Fp>& Q, int r, bool live) {
  const bool full = live && !fp_is_zero(P.Z) && !fp_is_zero(Q.z);
  if (__any_sync(kFull, full)) {
    for (int k = 0; k < PT_GADD_ROUNDS; ++k) {
      if (full && r < pt_gadd_products(k)) g1_product(&P, &Q, false, k, r);
      __syncwarp();
    }
  }
  int twice = 0;
  if (live && r == 0) twice = pt_gadd_finish(P, Q);
  __syncwarp();
  twice = __shfl_sync(kFull, twice, group_base());
  g1_dbl(P, r, twice != 0);
}

// blocks for `lanes` independent group lanes: one warp a block while
// there are fewer warps than SMs (each its own SM), else up to
// G1_MAX_WARPS warps a block; `threads` gets the block's size
int lane_blocks(int64_t lanes, int n_sm, int& threads) {
  const int64_t warps = (lanes + G1_WARP_LANES - 1) / G1_WARP_LANES;
  int wpb = (int)((warps + n_sm - 1) / n_sm);
  wpb = wpb < 1 ? 1 : (wpb > G1_MAX_WARPS ? G1_MAX_WARPS : wpb);
  threads = 32 * wpb;
  return (int)((warps + wpb - 1) / wpb);
}

// the current device's SM count, or the error that reading it gave
cudaError_t sm_count(int& n) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
}

}  // namespace
