// Kernels K13 msm_pippenger and K14 msm_double_add: the G1 multiscalar
// multiplication sum_i k_i P_i of `g1_multi_exp_device`, one Jacobian
// point (canonical limbs), Pippenger's buckets up to 512 lanes and a
// double-and-add per lane above (the JAX crossover), both on the G1 group
// lanes of `bls_g1_group.cuh` (a point on G1_RANKS threads, a round of
// the doubling or the general addition one product deep).
//
//   K13 replaces curve_jax.py:188 pt_msm_pippenger as
//       bls_batch/__init__.py:367 _msm_pippenger_kernel runs it.  Three
//       launches: the points to Montgomery form; one block a c-bit window,
//       its 2^c buckets in shared memory, whose groups each own the
//       buckets d = g + 1 (mod the group count) and walk the digit column
//       in point order, adding each of their points into its bucket
//       (bucket 0 is never read); then the window's suffix sum
//       running += B_k, acc += running for k = 2^c - 1 .. 1 on two groups
//       of one warp, acc one step behind running, running_k written over
//       bucket k (never read again); last, one group combines the windows
//       most significant first, c doublings and one addition each.
//   K14 replaces bls_batch/__init__.py:347 _msm_kernel (curve_jax.py:147
//       pt_scalar_mul over 255 bits, then :252 pt_sum).  One group a lane
//       runs the 255-bit double-and-add MSB first from its leading set bit
//       (T = P there); a warp's eight lanes double together and add P
//       together, each where its bit is set, so a warp's chain is a
//       doubling and, with odds 1 - 2^-8, an addition a bit.  (Each lane
//       in its own pass, a round picking each rank's product from its
//       lane's pass, cut the rounds by a fifth but cost 4.3 us a round
//       against 2.1 on an H100: its divergent finishes and state.)
//       Masked lanes and zero scalars stay at infinity.  Then pt_sum's
//       tree, one launch a level: level m adds lane i + m into lane i, a
//       group a pair.
//
//   K27 g1_shard_fold replaces the fold of bls_batch/__init__.py:484
//       _msm_sharded_kernel (:513, curve_jax.py:252 pt_sum over the D
//       gathered Jacobian partials of the sharded MSM, one K13 per
//       shard): a load launch (the D partials to Montgomery form, the
//       rows up to the next power of two infinity), then K14's tree.
//
// All keep JAX's formulas and order of point additions, so the Jacobian
// coordinates of every finite point, not only the points, equal JAX's at
// canonical values; a point at infinity's X and Y are nobody's.  What
// bounds them: the chain of dependent Montgomery products, a round of
// the passes at a time (a doubling is 3 rounds, an addition 5).  K13's
// longest chain is the suffix sum's 2^c additions and the combine's
// (W - 1)(3c + 5) rounds; K14's a warp's 254 doublings and the additions
// of the bits where one of its lanes is set, then 5 rounds a tree level.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bls_g1_group.cuh"

#define MSM_MAX_GROUPS 64     // groups of a K13 window block
#define MSM_BITS_WORDS 8      // a K14 lane's scalar bits, packed (<= 256)

namespace {

constexpr int kLoadBlock = 128;

// a group's accumulator and the point it adds
struct MsmGroup {
  GroupJac<Fp> P;
  Jac<Fp> Q;
};

// the group's point T, canonical (X, Y, Z), to out (3, 33)
__device__ __forceinline__ void store_group(int32_t* out,
                                            const GroupJac<Fp>& P, int r) {
  if (r < 3) store_fp(out + r * BLS_NL, r == 0 ? P.X : (r == 1 ? P.Y : P.Z));
}

// --- K13 -------------------------------------------------------------------

__global__ void __launch_bounds__(kLoadBlock)
msm_load_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ y,
                int B, Jac<Fp>* __restrict__ pts) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  Jac<Fp> p;
  load_fp(p.x, x + (int64_t)i * BLS_NL);
  load_fp(p.y, y + (int64_t)i * BLS_NL);
  fp_one(p.z);
  pts[i] = p;
}

// one block a window w = blockIdx.x: the bucket pass, then the suffix sum
// to sums[w]; the buckets in shared memory after the groups
__global__ void __launch_bounds__(MSM_MAX_GROUPS * G1_RANKS)
msm_window_kernel(const Jac<Fp>* __restrict__ pts,
                  const int32_t* __restrict__ digits, int B, int W, int c,
                  Jac<Fp>* __restrict__ sums) {
  extern __shared__ __align__(16) unsigned char g1_smem[];
  const int w = blockIdx.x, nb = 1 << c;
  const int G = blockDim.x / G1_RANKS, g = threadIdx.x / G1_RANKS,
            r = threadIdx.x % G1_RANKS;
  MsmGroup* grp = (MsmGroup*)g1_smem;
  MsmGroup& S = grp[g];
  Jac<Fp>* bk = (Jac<Fp>*)(grp + G);
  for (int k = threadIdx.x; k < nb; k += blockDim.x) pt_infinity(bk[k]);
  __syncthreads();

  // the bucket pass: each group its points in order, d - 1 = g (mod G)
  int i = 0;
  for (;;) {
    int d = 0;
    for (; i < B; ++i) {
      d = digits[(int64_t)i * W + w];
      if (d && (d - 1) % G == g) break;
    }
    const bool found = i < B;
    if (!__any_sync(kFull, found)) break;
    if (found) {
      copy_pt(&S.P, &bk[d], r);
      copy_pt(&S.Q, &pts[i], r);
    }
    __syncwarp();
    g1_add(S.P, S.Q, r, found);
    if (found) copy_pt(&bk[d], &S.P, r);
    __syncwarp();
    ++i;
  }
  __syncthreads();

  // the suffix sum on warp 0, k = nb - 1 .. 1: group 0 runs running += B_k
  // and writes running_k over bucket k; group 1, a step behind, runs
  // acc += running_(k+1) from bucket k + 1
  if (threadIdx.x >= 32) return;
  if (g < 2) set_infinity(S.P, r);
  __syncwarp();
  for (int s = 0; s < nb; ++s) {
    const int k = nb - 1 - s;
    const bool run = g == 0 && k >= 1, acc = g == 1 && s >= 1;
    const Jac<Fp>& q = bk[g == 0 ? k : min(k + 1, nb - 1)];
    g1_add(S.P, q, r, run || acc);
    if (run) copy_pt(&bk[k], &S.P, r);
    __syncwarp();
  }
  if (g == 1) copy_pt(&sums[w], &S.P, r);
}

// one warp: res = sum over the windows, most significant first, of
// 2^c res + sums[w], on group 0; canonical (X, Y, Z) to out
__global__ void __launch_bounds__(32)
msm_combine_kernel(const Jac<Fp>* __restrict__ sums, int W, int c,
                   int32_t* __restrict__ out) {
  __shared__ MsmGroup S;
  const int g = threadIdx.x / G1_RANKS, r = threadIdx.x % G1_RANKS;
  const bool live = g == 0;
  if (live) set_infinity(S.P, r);
  __syncwarp();
  for (int w = 0; w < W; ++w) {
    for (int j = 0; j < c; ++j) g1_dbl(S.P, r, live);
    if (live) copy_pt(&S.Q, &sums[w], r);
    __syncwarp();
    g1_add(S.P, S.Q, r, live);
  }
  if (live) store_group(out, S.P, r);
}

// --- K14 -------------------------------------------------------------------

struct DaLane {
  MsmGroup S;                   // T, and the lane's base point P
  uint32_t bits[MSM_BITS_WORDS];   // the scalar's bits, bit i at i / 32
};

__global__ void __launch_bounds__(G1_MAX_WARPS * 32)
msm_lanes_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ y,
                 const int32_t* __restrict__ bits,
                 const uint8_t* __restrict__ mask, int nbits, int B,
                 Jac<Fp>* __restrict__ lanes) {
  extern __shared__ __align__(16) unsigned char g1_smem[];
  const int g = threadIdx.x / G1_RANKS, r = threadIdx.x % G1_RANKS;
  const int lane = blockIdx.x * (blockDim.x / G1_RANKS) + g;
  DaLane& L = ((DaLane*)g1_smem)[g];
  GroupJac<Fp>& P = L.S.P;
  const Jac<Fp>& Q = L.S.Q;
  const bool valid = lane < B;
  const int32_t* lb = bits + (int64_t)(valid ? lane : 0) * nbits;
  if (valid) {
    for (int k = r; k < MSM_BITS_WORDS; k += G1_RANKS) {
      uint32_t v = 0;
      for (int j = 0; j < 32 && 32 * k + j < nbits; ++j)
        v |= (uint32_t)(lb[32 * k + j] != 0) << j;
      L.bits[k] = v;
    }
    if (r == 0) {
      load_fp(L.S.Q.x, x + (int64_t)lane * BLS_NL);
      load_fp(L.S.Q.y, y + (int64_t)lane * BLS_NL);
      fp_one(L.S.Q.z);
    }
    set_infinity(P, r);
  }
  __syncwarp();

  // T = P at the lane's leading set bit; after it, the warp's lanes
  // double together and add P together where their bits are set (a
  // masked lane, or a zero scalar, stays at infinity)
  const bool live = valid && mask[lane];
  int lead = nbits;
  if (live)
    for (int j = 0; j < nbits; ++j)
      if (L.bits[j >> 5] >> (j & 31) & 1) {
        lead = j;
        break;
      }
  if (lead < nbits) copy_pt(&P, &Q, r);
  __syncwarp();
  for (int j = warp_min(lead) + 1; j < nbits; ++j) {
    const bool after = j > lead;
    g1_dbl(P, r, after);
    g1_add(P, Q, r, after && (L.bits[j >> 5] >> (j & 31) & 1));
  }
  if (valid) copy_pt(&lanes[lane], &P, r);
}

// level m of pt_sum's tree: lanes[i] += lanes[i + m] for i < m, a group a
// pair; at m = 1, the sum's canonical (X, Y, Z) to out as well
__global__ void __launch_bounds__(G1_MAX_WARPS * 32)
msm_tree_kernel(Jac<Fp>* __restrict__ lanes, int m,
                int32_t* __restrict__ out) {
  __shared__ MsmGroup grp[G1_MAX_WARPS * G1_WARP_LANES];
  const int g = threadIdx.x / G1_RANKS, r = threadIdx.x % G1_RANKS;
  const int i = blockIdx.x * (blockDim.x / G1_RANKS) + g;
  MsmGroup& S = grp[g];
  const bool valid = i < m;
  if (valid) {
    copy_pt(&S.P, &lanes[i], r);
    copy_pt(&S.Q, &lanes[i + m], r);
  }
  __syncwarp();
  g1_add(S.P, S.Q, r, valid);
  if (valid) copy_pt(&lanes[i], &S.P, r);
  if (valid && m == 1) store_group(out, S.P, r);
}

// m = 1: the one lane's canonical (X, Y, Z) to out
__global__ void msm_store_kernel(const Jac<Fp>* __restrict__ lanes,
                                 int32_t* __restrict__ out) {
  const int r = threadIdx.x;
  if (r < 3) store_fp(out + r * BLS_NL,
                      r == 0 ? lanes[0].x : (r == 1 ? lanes[0].y : lanes[0].z));
}

// lanes[0] <- the sum of lanes[0..m), m a power of two, in pt_sum's tree,
// and its canonical (X, Y, Z) to out
cudaError_t tree_launch(Jac<Fp>* lanes, int m, int32_t* out, int n_sm,
                        cudaStream_t stream) {
  if (m == 1) {
    msm_store_kernel<<<1, 32, 0, stream>>>(lanes, out);
    return cudaGetLastError();
  }
  for (int h = m / 2; h >= 1; h /= 2) {
    int threads = 0;
    const int blocks = lane_blocks(h, n_sm, threads);
    msm_tree_kernel<<<blocks, threads, 0, stream>>>(lanes, h, out);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// --- K27 -------------------------------------------------------------------

__global__ void __launch_bounds__(32)
g1_fold_load_kernel(const int32_t* __restrict__ x,
                    const int32_t* __restrict__ y,
                    const int32_t* __restrict__ z, int D, int m,
                    Jac<Fp>* __restrict__ lanes) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  Jac<Fp> p;
  if (i < D) {
    load_jac(p, x + i * BLS_NL, y + i * BLS_NL, z + i * BLS_NL);
  } else {
    pt_infinity(p);
  }
  lanes[i] = p;
}

// a K13 window block's groups and its shared memory
int window_groups(int c) {
  const int want = ((1 << c) - 1 + G1_WARP_LANES - 1) / G1_WARP_LANES;
  const int warps = want < 1 ? 1 : want;
  const int g = warps * G1_WARP_LANES;
  return g > MSM_MAX_GROUPS ? MSM_MAX_GROUPS : g;
}

size_t window_shmem(int c) {
  return window_groups(c) * sizeof(MsmGroup) +
         ((size_t)1 << c) * sizeof(Jac<Fp>);
}

constexpr int kMaxC = 10;   // the widest window whose buckets fit

}  // namespace

extern "C" {

int bls_set_constants(const uint32_t* words, int n_words) {
  const void* kernels[] = {(const void*)msm_load_kernel,
                           (const void*)msm_window_kernel,
                           (const void*)msm_combine_kernel,
                           (const void*)msm_lanes_kernel,
                           (const void*)msm_tree_kernel,
                           (const void*)msm_store_kernel,
                           (const void*)g1_fold_load_kernel};
  int err = bls_write_constants(words, n_words, kernels, 7);
  if (err) return err;
  return cudaFuncSetAttribute((const void*)msm_window_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)window_shmem(kMaxC));
}

// scratch: at least msm_pippenger_scratch_bytes(B, W, c) bytes
int64_t msm_pippenger_scratch_bytes(int B, int W, int c) {
  return ((int64_t)B + W) * sizeof(Jac<Fp>);
}

// x, y: (B, 33) affine limbs; digits: (B, W) c-bit windows (c <= 10),
// most significant first; out: (3, 33) canonical
int msm_pippenger_launch(const int32_t* x, const int32_t* y,
                         const int32_t* digits, int B, int W, int c,
                         void* scratch, int32_t* out, cudaStream_t stream) {
  if (B < 1 || W < 1 || c < 1 || c > kMaxC) return cudaErrorInvalidValue;
  Jac<Fp>* pts = (Jac<Fp>*)scratch;
  Jac<Fp>* sums = pts + B;
  msm_load_kernel<<<(B + kLoadBlock - 1) / kLoadBlock, kLoadBlock, 0,
                    stream>>>(x, y, B, pts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  msm_window_kernel<<<W, window_groups(c) * G1_RANKS, window_shmem(c),
                      stream>>>(pts, digits, B, W, c, sums);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  msm_combine_kernel<<<1, 32, 0, stream>>>(sums, W, c, out);
  return cudaGetLastError();
}

// scratch: at least msm_double_add_scratch_bytes(B) bytes
int64_t msm_double_add_scratch_bytes(int B) {
  return (int64_t)B * sizeof(Jac<Fp>);
}

// x, y: (B, 33) affine limbs, B a power of two; bits: (B, nbits) MSB
// first, nbits <= 256; mask: (B,); out: (3, 33) canonical
int msm_double_add_launch(const int32_t* x, const int32_t* y,
                          const int32_t* bits, const uint8_t* mask, int nbits,
                          int B, void* scratch, int32_t* out,
                          cudaStream_t stream) {
  if (B < 1 || (B & (B - 1)) || nbits < 0 || nbits > 32 * MSM_BITS_WORDS)
    return cudaErrorInvalidValue;
  int n_sm = 0;
  cudaError_t err = sm_count(n_sm);
  if (err != cudaSuccess) return err;
  Jac<Fp>* lanes = (Jac<Fp>*)scratch;
  int threads = 0;
  const int blocks = lane_blocks(B, n_sm, threads);
  msm_lanes_kernel<<<blocks, threads, threads / G1_RANKS * sizeof(DaLane),
                     stream>>>(x, y, bits, mask, nbits, B, lanes);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return tree_launch(lanes, B, out, n_sm, stream);
}

// scratch: at least g1_shard_fold_scratch_bytes(D) bytes
int64_t g1_shard_fold_scratch_bytes(int D) {
  int64_t m = 1;
  while (m < D) m *= 2;
  return m * sizeof(Jac<Fp>);
}

// K27: sum of the D Jacobian partials (x, y, z: D rows each) in pt_sum's
// tree, to out (X, Y, Z)
int g1_shard_fold_launch(const int32_t* x, const int32_t* y, const int32_t* z,
                         int D, void* scratch, int32_t* out,
                         cudaStream_t stream) {
  int m = 1;
  while (m < D) m *= 2;
  int n_sm = 0;
  cudaError_t err = sm_count(n_sm);
  if (err != cudaSuccess) return err;
  Jac<Fp>* lanes = (Jac<Fp>*)scratch;
  g1_fold_load_kernel<<<(m + 31) / 32, 32, 0, stream>>>(x, y, z, D, m, lanes);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return tree_launch(lanes, m, out, n_sm, stream);
}

}  // extern "C"
