// Kernels K19 g1_fft and K20 fk20_hext: the G1 arithmetic of the PeerDAS
// producer (FK20), over the Jacobian formulas of `bls12_381.cuh`.
//
//   K19 replaces g1fft_jax.py:161 _g1_fft_kernel with :130 _windowed_mul:
//       the batched G1 FFT or inverse FFT of (B, n) Jacobian points given
//       in bit-reversed order, natural order out.  Launches: one that
//       loads the limbs into Montgomery words, one per butterfly round
//       (the rounds need a global sync), and one that stores canonical
//       limbs, multiplying by 1/n first for the inverse (the fixed scalar
//       multiply of curve_jax.py:168 pt_scalar_mul_const: double, then
//       add on set bits).  A round runs one thread per (row, butterfly
//       lane): it loads u and v, builds the 16-entry multiple table of v
//       (evens by doubling, odds by one add, in JAX's order), walks the 64
//       most-significant-first 4-bit digits of its twiddle (4 doublings
//       and one table add per digit), and writes u + t and u - t in place.
//       The (u, v) indices and twiddle digits are `_stage_plan`'s host
//       constants, uploaded once per (n, inverse) by the wrapper.
//   K20 replaces g1fft_jax.py:202 _fk20_hext_kernel: for each of the
//       `width` positions j, the window-4 Pippenger MSM
//       sum_c k[c, j] X[c, j] over the R residue rows of the
//       device-resident FK20 setup tables (Jacobian points, so their
//       infinity lanes pass through).  One launch: one block per
//       position, one thread per window (64), K13's block
//       (`bls_msm.cu`) with Jacobian inputs.  The block stages its R
//       points in shared memory; each thread adds them in order into
//       its 16 buckets (zero digits skip: bucket 0 is never read),
//       reduces its buckets by the suffix sum; thread 0 combines the
//       windows most significant first, 4 doublings each.
//
// Both keep JAX's formulas and order of point additions, so the Jacobian
// coordinates, not only the points, equal the plain versions' at
// canonical values.  What bounds them: serial chains of dependent
// Montgomery products with few threads busy, so latency: K19's round is
// about 3,000 products on every thread, K20's thread 0 about 2,800 after
// its bucket pass.  The 16-entry table of a K19 thread and the 16
// buckets of a K20 thread (16 x 144 bytes each) live in local memory;
// K20's staged points and window sums (at most 192 x 144 bytes) in
// shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bls12_381.cuh"

#define G1FFT_DIGITS 64     // 4-bit windows of a 255-bit scalar
#define G1FFT_TABLE 16      // multiples 0..15 of v
#define FK20_MAX_RES 128    // residue rows a K20 block stages
#define FK20_BUCKETS 16

namespace {

constexpr int kFftBlock = 32;

__device__ __forceinline__ void load_jac(Jac<Fp>& p, const int32_t* x,
                                         const int32_t* y, const int32_t* z) {
  load_fp(p.x, x);
  load_fp(p.y, y);
  load_fp(p.z, z);
}

// --- K19 -------------------------------------------------------------------

__global__ void __launch_bounds__(kFftBlock)
g1_fft_load_kernel(const int32_t* __restrict__ x,
                   const int32_t* __restrict__ y,
                   const int32_t* __restrict__ z, int total,
                   Jac<Fp>* __restrict__ pts) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int64_t o = (int64_t)i * BLS_NL;
  Jac<Fp> p;
  load_jac(p, x + o, y + o, z + o);
  pts[i] = p;
}

// one butterfly round over every row: lane `lane` of row b pairs positions
// u_idx[lane] and v_idx[lane] and multiplies v by its twiddle, whose window
// digits are digits[lane * 64 ..] (most significant first)
__global__ void __launch_bounds__(kFftBlock)
g1_fft_round_kernel(Jac<Fp>* __restrict__ pts, int B, int n,
                    const int32_t* __restrict__ u_idx,
                    const int32_t* __restrict__ v_idx,
                    const int32_t* __restrict__ digits) {
  const int half = n / 2;
  int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= B * half) return;
  const int b = t / half, lane = t % half;
  Jac<Fp>* row = pts + (int64_t)b * n;
  const int ui = u_idx[lane], vi = v_idx[lane];
  const Jac<Fp> u = row[ui], v = row[vi];
  Jac<Fp> T[G1FFT_TABLE];
  pt_infinity(T[0]);
  T[1] = v;
  for (int d = 2; d < G1FFT_TABLE; ++d) {
    if (d % 2 == 0) pt_double(T[d], T[d / 2]);
    else pt_add(T[d], T[d - 1], v);
  }
  Jac<Fp> acc;
  pt_infinity(acc);
  const int32_t* dg = digits + (int64_t)lane * G1FFT_DIGITS;
  for (int w = 0; w < G1FFT_DIGITS; ++w) {
    for (int k = 0; k < 4; ++k) pt_double(acc, acc);
    pt_add(acc, acc, T[dg[w]]);
  }
  Jac<Fp> plus, minus, neg = acc;
  fp_neg(neg.y, acc.y);
  pt_add(plus, u, acc);
  pt_add(minus, u, neg);
  row[ui] = plus;
  row[vi] = minus;
}

// canonical limbs out, (3, total, 33); with nbits > 0 each point is first
// multiplied by the fixed scalar whose bits (most significant first) are
// `bits`
__global__ void __launch_bounds__(kFftBlock)
g1_fft_store_kernel(const Jac<Fp>* __restrict__ pts, int total,
                    const int32_t* __restrict__ bits, int nbits,
                    int32_t* __restrict__ out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  Jac<Fp> p = pts[i];
  if (nbits > 0) {
    Jac<Fp> acc;
    pt_infinity(acc);
    for (int j = 0; j < nbits; ++j) {
      pt_double(acc, acc);
      if (bits[j]) pt_add(acc, acc, p);
    }
    p = acc;
  }
  store_fp(out + (int64_t)i * BLS_NL, p.x);
  store_fp(out + ((int64_t)total + i) * BLS_NL, p.y);
  store_fp(out + (2 * (int64_t)total + i) * BLS_NL, p.z);
}

// --- K20 -------------------------------------------------------------------

__global__ void __launch_bounds__(G1FFT_DIGITS)
fk20_hext_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ y,
                 const int32_t* __restrict__ z,
                 const int32_t* __restrict__ digits, int R, int width,
                 int32_t* __restrict__ out) {
  __shared__ Jac<Fp> pts[FK20_MAX_RES];
  __shared__ Jac<Fp> sums[G1FFT_DIGITS];
  const int j = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  for (int i = tid; i < R; i += nt) {
    const int64_t o = ((int64_t)i * width + j) * BLS_NL;
    Jac<Fp> p;
    load_jac(p, x + o, y + o, z + o);
    pts[i] = p;
  }
  __syncthreads();
  if (tid < G1FFT_DIGITS) {
    const int w = tid;
    Jac<Fp> bk[FK20_BUCKETS];
    for (int k = 1; k < FK20_BUCKETS; ++k) pt_infinity(bk[k]);
    for (int i = 0; i < R; ++i) {           // the residue rows in order
      const int d = digits[((int64_t)i * width + j) * G1FFT_DIGITS + w];
      if (d == 0) continue;
      Jac<Fp> b = bk[d];
      pt_add(b, b, pts[i]);
      bk[d] = b;
    }
    Jac<Fp> running, acc;                   // sum_k k B_k, k = 15 .. 1
    pt_infinity(running);
    pt_infinity(acc);
    for (int k = FK20_BUCKETS - 1; k >= 1; --k) {
      pt_add(running, running, bk[k]);
      pt_add(acc, acc, running);
    }
    sums[w] = acc;
  }
  __syncthreads();
  if (tid == 0) {                           // windows, most significant first
    Jac<Fp> res;
    pt_infinity(res);
    for (int w = 0; w < G1FFT_DIGITS; ++w) {
      for (int k = 0; k < 4; ++k) pt_double(res, res);
      pt_add(res, res, sums[w]);
    }
    store_fp(out + (int64_t)j * BLS_NL, res.x);
    store_fp(out + ((int64_t)width + j) * BLS_NL, res.y);
    store_fp(out + (2 * (int64_t)width + j) * BLS_NL, res.z);
  }
}

int blocks_for(int64_t threads) {
  return (int)((threads + kFftBlock - 1) / kFftBlock);
}

}  // namespace

extern "C" {

int bls_set_constants(const uint32_t* words, int n_words) {
  const void* kernels[] = {(const void*)g1_fft_load_kernel,
                           (const void*)g1_fft_round_kernel,
                           (const void*)g1_fft_store_kernel,
                           (const void*)fk20_hext_kernel};
  return bls_write_constants(words, n_words, kernels, 4);
}

// scratch: at least g1_fft_scratch_bytes(B, n) bytes
int64_t g1_fft_scratch_bytes(int B, int n) {
  return (int64_t)B * n * sizeof(Jac<Fp>);
}

// x, y, z: (B, n, 33) limbs in bit-reversed order; u_idx, v_idx:
// (rounds, n / 2); digits: (rounds, n / 2, 64); inv_bits: n_inv_bits bits
// of the final scale (0 bits: none); out: (3, B, n, 33) canonical
int g1_fft_launch(const int32_t* x, const int32_t* y, const int32_t* z,
                  int B, int n, int rounds, const int32_t* u_idx,
                  const int32_t* v_idx, const int32_t* digits,
                  const int32_t* inv_bits, int n_inv_bits, void* scratch,
                  int32_t* out, cudaStream_t stream) {
  Jac<Fp>* pts = (Jac<Fp>*)scratch;
  const int total = B * n, half = n / 2;
  g1_fft_load_kernel<<<blocks_for(total), kFftBlock, 0, stream>>>(x, y, z,
                                                                  total, pts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  for (int s = 0; s < rounds; ++s) {
    g1_fft_round_kernel<<<blocks_for((int64_t)B * half), kFftBlock, 0,
                          stream>>>(
        pts, B, n, u_idx + (int64_t)s * half, v_idx + (int64_t)s * half,
        digits + (int64_t)s * half * G1FFT_DIGITS);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  g1_fft_store_kernel<<<blocks_for(total), kFftBlock, 0, stream>>>(
      pts, total, inv_bits, n_inv_bits, out);
  return cudaGetLastError();
}

// x, y, z: (R, width, 33) limbs, R <= 128; digits: (R, width, 64) 4-bit
// windows, most significant first; out: (3, width, 33) canonical
int fk20_hext_launch(const int32_t* x, const int32_t* y, const int32_t* z,
                     const int32_t* digits, int R, int width, int32_t* out,
                     cudaStream_t stream) {
  if (R < 1 || R > FK20_MAX_RES || width < 1) return cudaErrorInvalidValue;
  fk20_hext_kernel<<<width, G1FFT_DIGITS, 0, stream>>>(x, y, z, digits, R,
                                                       width, out);
  return cudaGetLastError();
}

}  // extern "C"
