// Kernels K19 g1_fft and K20 fk20_hext: the G1 arithmetic of the PeerDAS
// producer (FK20), on the group point passes of `bls_point_passes.cuh`
// (the doubling and the general addition T <- T + Q, Q Jacobian).
//
//   K19 replaces g1fft_jax.py:161 _g1_fft_kernel with :130 _windowed_mul:
//       the batched G1 FFT or inverse FFT of (B, n) Jacobian points given
//       in bit-reversed order, natural order out.  Launches: one that
//       loads the limbs into Montgomery words, one per butterfly round
//       (the rounds need a global sync), and one that stores canonical
//       limbs, multiplying by 1/n first for the inverse (the fixed scalar
//       multiply of curve_jax.py:168 pt_scalar_mul_const: double, then
//       add on set bits).  A round runs a group of G1_RANKS threads per
//       (row, butterfly lane), eight lanes a warp: the group loads u and
//       v, builds the multiples T[2..top] of v that the lane's digits
//       use (evens by doubling T[d/2], odds T[d-1] + v, JAX's recipe),
//       walks its twiddle's 4-bit digits from the first nonzero one (4
//       doublings and one addition of T[digit] a window; the accumulator
//       starts as T[first digit]), and writes u + t and u - t in place.
//       The (u, v) indices and twiddle digits are `_stage_plan`'s host
//       constants, uploaded once per (n, inverse) by the wrapper.
//   K20 replaces g1fft_jax.py:202 _fk20_hext_kernel: for each of the
//       `width` positions j, the window-4 Pippenger MSM
//       sum_c k[c, j] X[c, j] over the R residue rows of the
//       device-resident FK20 setup tables (Jacobian points, so their
//       infinity lanes pass through).  One launch: one block per
//       position, a group per window (64 windows, eight a warp).  The
//       block stages its R points in shared memory; each window's group
//       adds them in row order into its 16 buckets (zero digits skip:
//       bucket 0 is never read), reduces its buckets by the suffix sum;
//       window 0's group then combines the windows' sums most
//       significant first, 4 doublings each.
//
// Both keep JAX's formulas and order of point operations, so the
// Jacobian coordinates of every finite point, not only the points, equal
// the plain versions' at canonical values.  What a pass skips is work
// on a point at infinity, whose coordinates nobody reads: a doubling of
// T at infinity, and the rounds of an addition where T or Q is at
// infinity (its finish gives Q or keeps T, as pt_add does).  So a lane's
// accumulator at infinity costs nothing, and a lane whose twiddle is 1
// returns v: round 1 is a pure butterfly.
//
// What bounds them: the chain of dependent Montgomery products of the
// longest lane, a round of the passes at a time (a doubling is 3 rounds,
// an addition 5), with every lane's products on its ranks.  A round is
// one product deep, so its time is one product's latency, its operand
// picks, the additions between the products and a warp barrier.  Every
// point, table entry and temporary of a group lives in shared memory;
// the Fp product is one non-inlined copy (`g1_product`), which keeps the
// chains' code inside the instruction cache, as K8's is.  A block's
// lanes' groups run independently: each round meets only at warp
// barriers.  Lanes are spread over the SMs first (one warp a block while
// there are fewer warps than SMs).  On an H100 80GB HBM3 at 700 W a pass
// round's product (pick, product, store) takes about 1.3 us
// (`g1_product_chain`), and a round of a transform about 1.8 us.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bls_g1_group.cuh"

#define G1FFT_DIGITS 64     // 4-bit windows of a 255-bit scalar
#define G1FFT_TABLE 16      // multiples 0..15 of v
#define FK20_MAX_RES 128    // residue rows a K20 block stages
#define FK20_BUCKETS 16
#define FK20_THREADS (G1FFT_DIGITS * G1_RANKS)   // a group per window

namespace {

constexpr int kLoadBlock = 128;

// --- K19 ---------------------------------------------------------------------

struct FftLane {
  GroupJac<Fp> P;              // the accumulator t = k v, then u + t, u - t
  Jac<Fp> T[G1FFT_TABLE];      // T[d] = d v; T[0] holds t for the butterfly
  Jac<Fp> u;
};

struct PointLane {
  GroupJac<Fp> P;              // the accumulator of the 1/n multiple
  Jac<Fp> p;
};

__global__ void __launch_bounds__(kLoadBlock)
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
__global__ void __launch_bounds__(G1_MAX_WARPS * 32)
g1_fft_round_kernel(Jac<Fp>* __restrict__ pts, int B, int n,
                    const int32_t* __restrict__ u_idx,
                    const int32_t* __restrict__ v_idx,
                    const int32_t* __restrict__ digits) {
  extern __shared__ __align__(16) unsigned char g1_smem[];
  const int g = threadIdx.x / G1_RANKS, r = threadIdx.x % G1_RANKS;
  FftLane& L = ((FftLane*)g1_smem)[g];
  GroupJac<Fp>& P = L.P;
  const int half = n / 2;
  const int64_t t = (int64_t)blockIdx.x * (blockDim.x / G1_RANKS) + g;
  const bool valid = t < (int64_t)B * half;
  const int b = valid ? (int)(t / half) : 0;
  const int lane = valid ? (int)(t % half) : 0;
  Jac<Fp>* row = pts + (int64_t)b * n;
  const int ui = u_idx[lane], vi = v_idx[lane];
  const int32_t* dg = digits + (int64_t)lane * G1FFT_DIGITS;
  int first = G1FFT_DIGITS, top = 0;        // first nonzero window, top digit
  if (valid) {
    for (int w = G1FFT_DIGITS - 1; w >= 0; --w) {
      const int d = dg[w];
      if (d) first = w;
      top = max(top, d);
    }
    copy_pt(&L.u, &row[ui], r);
    copy_pt(&L.T[1], &row[vi], r);
  }
  __syncwarp();

  // the multiples of v that the digits use: evens by doubling, odds by
  // adding v
  const int wtop = warp_max(top);
  for (int d = 2; d <= wtop; ++d) {
    const bool live = valid && d <= top;
    if (live) copy_pt(&P, &L.T[d % 2 ? d - 1 : d / 2], r);
    __syncwarp();
    if (d % 2) g1_add(P, L.T[1], r, live);
    else g1_dbl(P, r, live);
    if (live) copy_pt(&L.T[d], &P, r);
    __syncwarp();
  }

  // t = k v: from the first nonzero window (t = T[digit] there), four
  // doublings and an addition of T[digit] a window (digit 0: none)
  if (valid) set_infinity(P, r);
  __syncwarp();
  for (int w = warp_min(first); w < G1FFT_DIGITS; ++w) {
    const bool after = valid && w > first;
    const int d = valid ? dg[w] : 0;
    for (int i = 0; i < 4; ++i) g1_dbl(P, r, after);
    g1_add(P, L.T[d], r, after && d != 0);
    if (valid && w == first) copy_pt(&P, &L.T[d], r);
    __syncwarp();
  }

  // the butterfly: u + t to u's position, u + (-t) to v's
  if (valid) copy_pt(&L.T[0], &P, r);
  __syncwarp();
  if (valid) copy_pt(&P, &L.u, r);
  __syncwarp();
  g1_add(P, L.T[0], r, valid);
  if (valid) copy_pt(&row[ui], &P, r);
  __syncwarp();
  if (valid) {
    copy_pt(&P, &L.u, r);
    if (r == 0) fp_neg(L.T[0].y, L.T[0].y);
  }
  __syncwarp();
  g1_add(P, L.T[0], r, valid);
  if (valid) copy_pt(&row[vi], &P, r);
}

// canonical limbs out, (3, total, 33); with nbits > 0 each point is first
// multiplied by the fixed scalar whose bits (most significant first) are
// `bits`: from its leading set bit (T = p), a doubling a bit and an
// addition of p on each set bit
__global__ void __launch_bounds__(G1_MAX_WARPS * 32)
g1_fft_store_kernel(const Jac<Fp>* __restrict__ pts, int total,
                    const int32_t* __restrict__ bits, int nbits,
                    int32_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char g1_smem[];
  const int g = threadIdx.x / G1_RANKS, r = threadIdx.x % G1_RANKS;
  PointLane& L = ((PointLane*)g1_smem)[g];
  GroupJac<Fp>& P = L.P;
  const int64_t i = (int64_t)blockIdx.x * (blockDim.x / G1_RANKS) + g;
  const bool valid = i < total;
  if (valid) {
    copy_pt(&L.p, &pts[i], r);
    copy_pt(&P, &pts[i], r);
  }
  __syncwarp();
  int lead = 0;
  while (lead < nbits && !bits[lead]) ++lead;
  if (nbits > 0 && lead == nbits && valid) set_infinity(P, r);
  __syncwarp();
  for (int j = lead + 1; j < nbits; ++j) {
    g1_dbl(P, r, valid);
    if (bits[j]) g1_add(P, L.p, r, valid);
  }
  if (valid && r < 3) store_fp(out + ((int64_t)r * total + i) * BLS_NL,
                               r == 0 ? P.X : (r == 1 ? P.Y : P.Z));
}

// --- K20 ---------------------------------------------------------------------

struct Fk20Window {
  GroupJac<Fp> P;
  Jac<Fp> bk[FK20_BUCKETS];    // buckets 1..15; bk[0] the suffix's running
                               // sum, bk[15] its total once bucket 15 is read
};

__global__ void __launch_bounds__(FK20_THREADS)
fk20_hext_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ y,
                 const int32_t* __restrict__ z,
                 const int32_t* __restrict__ digits, int R, int width,
                 int32_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char g1_smem[];
  Jac<Fp>* pts = (Jac<Fp>*)g1_smem;
  Fk20Window* win = (Fk20Window*)(pts + R);
  const int j = blockIdx.x, w = threadIdx.x / G1_RANKS,
            r = threadIdx.x % G1_RANKS;
  Fk20Window& W = win[w];
  GroupJac<Fp>& P = W.P;
  for (int i = threadIdx.x; i < 3 * R; i += blockDim.x) {
    const int row = i / 3, c = i % 3;
    const int32_t* src = (c == 0 ? x : (c == 1 ? y : z)) +
                         ((int64_t)row * width + j) * BLS_NL;
    load_fp(c == 0 ? pts[row].x : (c == 1 ? pts[row].y : pts[row].z), src);
  }
  for (int k = r; k < FK20_BUCKETS; k += G1_RANKS) pt_infinity(W.bk[k]);
  __syncthreads();

  // the bucket pass: the rows in order, each into the bucket of its digit
  for (int i = 0; i < R; ++i) {
    const int d = digits[((int64_t)i * width + j) * G1FFT_DIGITS + w];
    if (d) copy_pt(&P, &W.bk[d], r);
    __syncwarp();
    g1_add(P, pts[i], r, d != 0);
    if (d) copy_pt(&W.bk[d], &P, r);
    __syncwarp();
  }

  // the suffix sum, k = 15 .. 1: running += B_k, sum += running
  for (int k = FK20_BUCKETS - 1; k >= 1; --k) {
    copy_pt(&P, &W.bk[0], r);
    __syncwarp();
    g1_add(P, W.bk[k], r, true);
    copy_pt(&W.bk[0], &P, r);
    __syncwarp();
    if (k == FK20_BUCKETS - 1) set_infinity(P, r);
    else copy_pt(&P, &W.bk[FK20_BUCKETS - 1], r);
    __syncwarp();
    g1_add(P, W.bk[0], r, true);
    copy_pt(&W.bk[FK20_BUCKETS - 1], &P, r);
    __syncwarp();
  }
  __syncthreads();

  // window 0's group: the windows' sums, most significant first
  if (threadIdx.x >= 32) return;
  const bool live = w == 0;
  if (live) set_infinity(P, r);
  __syncwarp();
  for (int v = 0; v < G1FFT_DIGITS; ++v) {
    for (int i = 0; i < 4; ++i) g1_dbl(P, r, live);
    g1_add(P, win[v].bk[FK20_BUCKETS - 1], r, live);
  }
  if (live && r < 3) store_fp(out + ((int64_t)r * width + j) * BLS_NL,
                              r == 0 ? P.X : (r == 1 ? P.Y : P.Z));
}

// --- the product's latency ----------------------------------------------------

// n dependent products through g1_product on one thread (each an operand
// pick, the product and its store to shared memory): the latency of a
// round's product, for the chains' floor
__global__ void g1_product_chain_kernel(const int32_t* __restrict__ a, int n,
                                        int32_t* __restrict__ out) {
  __shared__ GroupJac<Fp> P;
  if (threadIdx.x) return;
  load_fp(P.X, a);
  for (int i = 0; i < n; ++i) {
    g1_product(&P, nullptr, true, 0, 0);    // X^2
    P.X = P.t[pXX];
  }
  store_fp(out, P.X);
}

}  // namespace

extern "C" {

int bls_set_constants(const uint32_t* words, int n_words) {
  const void* kernels[] = {(const void*)g1_fft_load_kernel,
                           (const void*)g1_fft_round_kernel,
                           (const void*)g1_fft_store_kernel,
                           (const void*)fk20_hext_kernel,
                           (const void*)g1_product_chain_kernel};
  int err = bls_write_constants(words, n_words, kernels, 5);
  if (err) return err;
  // the groups' shared memory: up to four warps of FftLane, a K20 block's
  // 64 windows and 128 staged points
  const int fft = G1_MAX_WARPS * G1_WARP_LANES * (int)sizeof(FftLane);
  const int fk20 = FK20_MAX_RES * (int)sizeof(Jac<Fp>) +
                   G1FFT_DIGITS * (int)sizeof(Fk20Window);
  err = cudaFuncSetAttribute((const void*)g1_fft_round_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, fft);
  if (err) return err;
  err = cudaFuncSetAttribute((const void*)g1_fft_store_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             G1_MAX_WARPS * G1_WARP_LANES *
                                 (int)sizeof(PointLane));
  if (err) return err;
  return cudaFuncSetAttribute((const void*)fk20_hext_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              fk20);
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
  int n_sm = 0;
  cudaError_t err = sm_count(n_sm);
  if (err != cudaSuccess) return err;
  g1_fft_load_kernel<<<(total + kLoadBlock - 1) / kLoadBlock, kLoadBlock, 0,
                       stream>>>(x, y, z, total, pts);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  int threads = 0;
  const int blocks = lane_blocks((int64_t)B * half, n_sm, threads);
  const size_t shmem = threads / G1_RANKS * sizeof(FftLane);
  for (int s = 0; s < rounds; ++s) {
    g1_fft_round_kernel<<<blocks, threads, shmem, stream>>>(
        pts, B, n, u_idx + (int64_t)s * half, v_idx + (int64_t)s * half,
        digits + (int64_t)s * half * G1FFT_DIGITS);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const int sblocks = lane_blocks(total, n_sm, threads);
  g1_fft_store_kernel<<<sblocks, threads,
                        threads / G1_RANKS * sizeof(PointLane), stream>>>(
      pts, total, inv_bits, n_inv_bits, out);
  return cudaGetLastError();
}

// x, y, z: (R, width, 33) limbs, R <= 128; digits: (R, width, 64) 4-bit
// windows, most significant first; out: (3, width, 33) canonical
int fk20_hext_launch(const int32_t* x, const int32_t* y, const int32_t* z,
                     const int32_t* digits, int R, int width, int32_t* out,
                     cudaStream_t stream) {
  if (R < 1 || R > FK20_MAX_RES || width < 1) return cudaErrorInvalidValue;
  const size_t shmem =
      R * sizeof(Jac<Fp>) + G1FFT_DIGITS * sizeof(Fk20Window);
  fk20_hext_kernel<<<width, FK20_THREADS, shmem, stream>>>(x, y, z, digits,
                                                           R, width, out);
  return cudaGetLastError();
}

// a: (33,) limbs; out: (33,) canonical, a^(2^n): n dependent products
int g1_product_chain_launch(const int32_t* a, int n, int32_t* out,
                            cudaStream_t stream) {
  g1_product_chain_kernel<<<1, 32, 0, stream>>>(a, n, out);
  return cudaGetLastError();
}

}  // extern "C"
