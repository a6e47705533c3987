// Kernels K13 msm_pippenger and K14 msm_double_add: the G1 multiscalar
// multiplication sum_i k_i P_i of `g1_multi_exp_device`, one Jacobian
// point (canonical limbs), Pippenger's buckets up to 512 lanes and a
// double-and-add per lane above (the JAX crossover).
//
//   K13 replaces curve_jax.py:188 pt_msm_pippenger as
//       bls_batch/__init__.py:367 _msm_pippenger_kernel runs it.  One
//       block: the points go to Montgomery form once; then one thread per
//       c-bit window walks the B points in order, adding each into its
//       bucket of that window (bucket 0 never read), and reduces its 2^c
//       buckets by the suffix sum; thread 0 combines the windows MSB
//       first, c doublings each.  The bucket grid, W x 2^c Jacobian
//       points (1.2 MB at B = 512, c = 8), is scratch.
//   K14 replaces bls_batch/__init__.py:347 _msm_kernel (curve_jax.py:147
//       pt_scalar_mul over 255 bits, then :252 pt_sum).  Two launches, one
//       kernel row: one thread per lane runs the 255-bit double-and-add
//       MSB first (pad lanes to infinity), then one block sums the lanes
//       in pt_sum's tree (first half plus second, halving).
//
//   K27 g1_shard_fold replaces the fold of bls_batch/__init__.py:484
//       _msm_sharded_kernel (:513, curve_jax.py:252 pt_sum over the D
//       gathered Jacobian partials of the sharded MSM, one K13 per
//       shard): a load launch (the D partials to Montgomery form, the
//       rows up to the next power of two infinity), then K14's tree
//       launch, msm_tree_kernel as it is, over those rows.
//
// All keep JAX's order of point additions, so the Jacobian coordinates,
// not only the points, equal JAX's.  What bounds them: the serial chains
// of dependent Montgomery products (K13: B + 2^(c+1) + W (c + 1) point
// operations on its longest thread; K14: 255 doublings and up to 255
// additions per lane), with at most a few hundred threads busy: latency.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bls12_381.cuh"

namespace {

__device__ __forceinline__ void store_jac(int32_t* out, const Jac<Fp>& p) {
  store_fp(out, p.x);
  store_fp(out + BLS_NL, p.y);
  store_fp(out + 2 * BLS_NL, p.z);
}

// --- K13 -------------------------------------------------------------------

__global__ void __launch_bounds__(64)
msm_pippenger_kernel(const int32_t* __restrict__ x,
                     const int32_t* __restrict__ y,
                     const int32_t* __restrict__ digits, int B, int W, int c,
                     Jac<Fp>* __restrict__ pts, Jac<Fp>* __restrict__ buckets,
                     Jac<Fp>* __restrict__ sums, int32_t* __restrict__ out) {
  const int tid = threadIdx.x, nt = blockDim.x, nb = 1 << c;
  for (int i = tid; i < B; i += nt) {
    load_fp(pts[i].x, x + i * BLS_NL);
    load_fp(pts[i].y, y + i * BLS_NL);
    fp_one(pts[i].z);
  }
  __syncthreads();
  for (int w = tid; w < W; w += nt) {
    Jac<Fp>* bk = buckets + (int64_t)w * nb;
    for (int k = 1; k < nb; ++k) pt_infinity(bk[k]);
    for (int i = 0; i < B; ++i) {           // the points in order
      const int d = digits[i * W + w];
      if (d == 0) continue;
      Jac<Fp> b = bk[d];
      pt_add(b, b, pts[i]);
      bk[d] = b;
    }
    Jac<Fp> running, acc;                   // sum_k k B_k, k = nb-1 .. 1
    pt_infinity(running);
    pt_infinity(acc);
    for (int k = nb - 1; k >= 1; --k) {
      pt_add(running, running, bk[k]);
      pt_add(acc, acc, running);
    }
    sums[w] = acc;
  }
  __syncthreads();
  if (tid == 0) {                           // windows, most significant first
    Jac<Fp> res;
    pt_infinity(res);
    for (int w = 0; w < W; ++w) {
      for (int j = 0; j < c; ++j) pt_double(res, res);
      pt_add(res, res, sums[w]);
    }
    store_jac(out, res);
  }
}

// --- K14 -------------------------------------------------------------------

__global__ void __launch_bounds__(32)
msm_lanes_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ y,
                 const int32_t* __restrict__ bits,
                 const uint8_t* __restrict__ mask, int nbits, int B,
                 Jac<Fp>* __restrict__ lanes) {
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  Jac<Fp> p, acc;
  load_fp(p.x, x + lane * BLS_NL);
  load_fp(p.y, y + lane * BLS_NL);
  fp_one(p.z);
  pt_infinity(acc);
  const int32_t* lane_bits = bits + (int64_t)lane * nbits;
  for (int i = 0; i < nbits; ++i) {
    pt_double(acc, acc);
    if (lane_bits[i]) pt_add(acc, acc, p);
  }
  if (!mask[lane]) pt_infinity(acc);
  lanes[lane] = acc;
}

// lanes[0] <- the sum of lanes[0..m), m a power of two, in pt_sum's tree
__global__ void __launch_bounds__(1024)
msm_tree_kernel(Jac<Fp>* __restrict__ lanes, int m, int32_t* __restrict__ out) {
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int w = m / 2; w >= 1; w /= 2) {
    for (int i = tid; i < w; i += nt) {
      Jac<Fp> a = lanes[i], b = lanes[i + w];
      pt_add(a, a, b);
      lanes[i] = a;
    }
    __syncthreads();
  }
  if (tid == 0) store_jac(out, lanes[0]);
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
    load_fp(p.x, x + i * BLS_NL);
    load_fp(p.y, y + i * BLS_NL);
    load_fp(p.z, z + i * BLS_NL);
  } else {
    pt_infinity(p);
  }
  lanes[i] = p;
}

}  // namespace

extern "C" {

int bls_set_constants(const uint32_t* words, int n_words) {
  const void* kernels[] = {(const void*)msm_pippenger_kernel,
                           (const void*)msm_lanes_kernel,
                           (const void*)msm_tree_kernel,
                           (const void*)g1_fold_load_kernel};
  return bls_write_constants(words, n_words, kernels, 4);
}

// scratch: at least msm_pippenger_scratch_bytes(B, W, c) bytes
int64_t msm_pippenger_scratch_bytes(int B, int W, int c) {
  return ((int64_t)B + (int64_t)W * (1 << c) + W) * sizeof(Jac<Fp>);
}

int msm_pippenger_launch(const int32_t* x, const int32_t* y,
                         const int32_t* digits, int B, int W, int c,
                         void* scratch, int32_t* out, cudaStream_t stream) {
  Jac<Fp>* pts = (Jac<Fp>*)scratch;
  Jac<Fp>* buckets = pts + B;
  Jac<Fp>* sums = buckets + (int64_t)W * (1 << c);
  int threads = ((W + 31) / 32) * 32;
  msm_pippenger_kernel<<<1, threads, 0, stream>>>(x, y, digits, B, W, c, pts,
                                                  buckets, sums, out);
  return cudaGetLastError();
}

// scratch: at least msm_double_add_scratch_bytes(B) bytes
int64_t msm_double_add_scratch_bytes(int B) {
  return (int64_t)B * sizeof(Jac<Fp>);
}

// B a power of two
int msm_double_add_launch(const int32_t* x, const int32_t* y,
                          const int32_t* bits, const uint8_t* mask, int nbits,
                          int B, void* scratch, int32_t* out,
                          cudaStream_t stream) {
  Jac<Fp>* lanes = (Jac<Fp>*)scratch;
  msm_lanes_kernel<<<(B + 31) / 32, 32, 0, stream>>>(x, y, bits, mask, nbits,
                                                     B, lanes);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  int threads = B / 2 < 32 ? 32 : (B / 2 > 1024 ? 1024 : B / 2);
  msm_tree_kernel<<<1, threads, 0, stream>>>(lanes, B, out);
  return cudaGetLastError();
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
  Jac<Fp>* lanes = (Jac<Fp>*)scratch;
  g1_fold_load_kernel<<<(m + 31) / 32, 32, 0, stream>>>(x, y, z, D, m, lanes);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  int threads = m / 2 < 32 ? 32 : (m / 2 > 1024 ? 1024 : m / 2);
  msm_tree_kernel<<<1, threads, 0, stream>>>(lanes, m, out);
  return cudaGetLastError();
}

}  // extern "C"
