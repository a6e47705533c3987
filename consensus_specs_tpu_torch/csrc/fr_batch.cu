// Kernels K15-K18: the BLS12-381 scalar-field kernels of the KZG and DAS
// paths, over the device arithmetic of `fr.cuh`.
//
//   K15 fr_field_ops          one of mul, add, sub, inv, pow (a fixed
//                             exponent), canon, elementwise (holds the Fr
//                             layer, fr_batch.py:48 PrimeFieldKernel,
//                             against the plain version; not on a path)
//   K16 fr_barycentric        fr_batch.py:220 _barycentric_kernel:
//                             f(z) = (z^W - h^W) / (W h^W)
//                                    * sum_i f_i x_i / (z - x_i)
//                             over a width-W domain h G.  Two launches: a
//                             thread per lane (f_i x_i, z - x_i, its
//                             binary inverse, the product) and a block sum
//                             per kTermsBlock = 32 lanes (W = 4096: 128
//                             blocks, one an SM); then one block sums the
//                             partials and one thread forms z^W and the
//                             two scale products.
//   K17 fr_coset_interpolate  fr_batch.py:315 _coset_interpolate_kernel:
//                             S_j = sum_b w[b, j] sum_i e[b, i] M[i, j].
//                             A conversion launch puts the three inputs in
//                             Montgomery words; a thread per (b, j) forms
//                             its inner sum and weight, a block sums its
//                             256 / W rows per j; one thread per j sums the
//                             blocks.  Padded rows carry weight 0.
//   K18 fr_fft                fr_batch.py:417 _fr_fft_kernel: the radix-2
//                             DIT FFT of a batch of rows given in
//                             bit-reversed order, natural-order out, times
//                             a scale (1/n for the inverse).  A conversion
//                             launch, one launch per butterfly stage (a
//                             thread per butterfly, stage h twiddle i is
//                             roots[i n / (2h)]), a scale-and-store launch.
//
// Inputs and outputs are the port's boundary format (fr.cuh): (..., 33)
// int32 limbs, R = 2^396; outputs are canonical.  Sums are taken mod r
// in any order: the values are exact, so they equal the plain versions'
// (which follow JAX's order) at canonical values.
//
// Design, first version: a thread per independent element; K16's lanes
// each ran a 418-product Fermat chain (redesigned: `mont_inv_binary`,
// 512 branch-free steps of word additions and shifts, on 32-thread blocks
// spread over the SMs in place of 16 blocks of 256), K17's threads 65
// products, K18's one product per stage.  Every launcher returns the first
// non-zero cudaGetLastError() of its launches.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fr.cuh"

namespace {

enum FrOp { OP_MUL = 0, OP_ADD, OP_SUB, OP_INV, OP_POW, OP_CANON };

struct FrExp { uint32_t w[FR_NW]; };

constexpr int kBlock = 256;
constexpr int kTermsBlock = 32;   // K16's terms launch

// --- K15 -------------------------------------------------------------------

__global__ void __launch_bounds__(kBlock)
fr_field_ops_kernel(int op, FrExp e, const int32_t* __restrict__ a,
                    const int32_t* __restrict__ b, int32_t* __restrict__ out,
                    int64_t n) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Fr x, y;
  load_fr(x, a + i * FR_NL);
  switch (op) {
    case OP_MUL: load_fr(y, b + i * FR_NL); fr_mul(x, x, y); break;
    case OP_ADD: load_fr(y, b + i * FR_NL); fr_add(x, x, y); break;
    case OP_SUB: load_fr(y, b + i * FR_NL); fr_sub(x, x, y); break;
    case OP_INV: fr_inv(x, x); break;
    case OP_POW: fr_pow(x, x, e.w); break;
    default: break;
  }
  store_fr(out + i * FR_NL, x);
}

// boundary limbs -> Montgomery words, n elements
__global__ void __launch_bounds__(kBlock)
fr_load_kernel(const int32_t* __restrict__ src, int64_t n,
               Fr* __restrict__ dst) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) load_fr(dst[i], src + i * FR_NL);
}

// sum of s[0 .. blockDim) into s[0], blockDim a power of two
__device__ __forceinline__ void block_sum(Fr* s) {
  for (int h = blockDim.x / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h) fr_add(s[threadIdx.x], s[threadIdx.x],
                                s[threadIdx.x + h]);
    __syncthreads();
  }
}

// --- K16 -------------------------------------------------------------------

__global__ void __launch_bounds__(kTermsBlock)
fr_barycentric_terms_kernel(const int32_t* __restrict__ poly,
                            const int32_t* __restrict__ roots,
                            const int32_t* __restrict__ z, int W,
                            Fr* __restrict__ partial) {
  __shared__ Fr s[kTermsBlock];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  Fr t;
  fr_zero(t);
  if (i < W) {
    Fr f, x, zz, d;
    load_fr(f, poly + (int64_t)i * FR_NL);
    load_fr(x, roots + (int64_t)i * FR_NL);
    load_fr(zz, z);
    fr_mul(f, f, x);          // f_i x_i
    fr_sub(d, zz, x);         // z - x_i
    fr_inv_binary(d, d);      // 0 -> 0, as JAX's
    fr_mul(t, f, d);
  }
  s[threadIdx.x] = t;
  __syncthreads();
  block_sum(s);
  if (threadIdx.x == 0) partial[blockIdx.x] = s[0];
}

__global__ void __launch_bounds__(kBlock)
fr_barycentric_finish_kernel(const Fr* __restrict__ partial, int n_parts,
                             const int32_t* __restrict__ z,
                             const int32_t* __restrict__ h_pow_w,
                             const int32_t* __restrict__ inv_scale, int W,
                             int32_t* __restrict__ out) {
  __shared__ Fr s[kBlock];
  Fr acc;
  fr_zero(acc);
  for (int i = threadIdx.x; i < n_parts; i += blockDim.x)
    fr_add(acc, acc, partial[i]);
  s[threadIdx.x] = acc;
  __syncthreads();
  block_sum(s);
  if (threadIdx.x == 0) {
    Fr zz, zw, k;
    uint32_t e[FR_NW] = {(uint32_t)W, 0, 0, 0, 0, 0, 0, 0};
    load_fr(zz, z);
    fr_pow(zw, zz, e);        // z^W
    load_fr(k, h_pow_w);
    fr_sub(zw, zw, k);        // z^W - h^W
    fr_mul(acc, s[0], zw);
    load_fr(k, inv_scale);    // 1 / (W h^W)
    fr_mul(acc, acc, k);
    store_fr(out, acc);
  }
}

// --- K17 -------------------------------------------------------------------

__global__ void __launch_bounds__(kBlock)
fr_coset_fold_kernel(const Fr* __restrict__ ev, const Fr* __restrict__ M,
                     const Fr* __restrict__ wt, int B, int Wd,
                     Fr* __restrict__ partial) {
  __shared__ Fr s[kBlock];
  const int j = threadIdx.x % Wd, row = threadIdx.x / Wd;
  const int rows = blockDim.x / Wd;
  const int b = blockIdx.x * rows + row;
  Fr acc;
  fr_zero(acc);
  if (b < B) {
    const Fr* e = ev + (int64_t)b * Wd;
    for (int i = 0; i < Wd; ++i) {
      Fr p;
      fr_mul(p, e[i], M[i * Wd + j]);
      fr_add(acc, acc, p);
    }
    fr_mul(acc, acc, wt[(int64_t)b * Wd + j]);
  }
  s[threadIdx.x] = acc;
  __syncthreads();
  for (int h = rows / 2; h > 0; h >>= 1) {
    if (row < h) fr_add(s[threadIdx.x], s[threadIdx.x],
                        s[threadIdx.x + h * Wd]);
    __syncthreads();
  }
  if (row == 0) partial[(int64_t)blockIdx.x * Wd + j] = s[threadIdx.x];
}

__global__ void __launch_bounds__(kBlock)
fr_coset_finish_kernel(const Fr* __restrict__ partial, int n_parts, int Wd,
                       int32_t* __restrict__ out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= Wd) return;
  Fr acc;
  fr_zero(acc);
  for (int p = 0; p < n_parts; ++p)
    fr_add(acc, acc, partial[(int64_t)p * Wd + j]);
  store_fr(out + (int64_t)j * FR_NL, acc);
}

// --- K18 -------------------------------------------------------------------

__global__ void __launch_bounds__(kBlock)
fr_fft_stage_kernel(Fr* __restrict__ x, const Fr* __restrict__ roots, int n,
                    int h, int64_t n_bfly) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_bfly) return;
  const int half = n / 2;
  const int64_t row = t / half;
  const int k = (int)(t % half);
  const int blk = k / h, i = k % h;
  Fr* base = x + row * n + (int64_t)blk * 2 * h + i;
  Fr u = base[0], v;
  fr_mul(v, base[h], roots[(int64_t)i * (n / (2 * h))]);
  fr_add(base[0], u, v);
  fr_sub(base[h], u, v);
}

__global__ void __launch_bounds__(kBlock)
fr_scale_store_kernel(const Fr* __restrict__ x,
                      const int32_t* __restrict__ scale, int64_t n,
                      int32_t* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Fr s, v;
  load_fr(s, scale);
  fr_mul(v, x[i], s);
  store_fr(out + i * FR_NL, v);
}

unsigned blocks_for(int64_t n) {
  return (unsigned)((n + kBlock - 1) / kBlock);
}

}  // namespace

extern "C" {

int fr_set_constants(const uint32_t* words, int n_words) {
  return fr_write_constants(words, n_words);
}

int fr_field_ops_launch(int op, const uint32_t* exponent, const int32_t* a,
                        const int32_t* b, int32_t* out, int64_t n,
                        cudaStream_t stream) {
  FrExp e;
  for (int j = 0; j < FR_NW; ++j) e.w[j] = exponent[j];
  fr_field_ops_kernel<<<blocks_for(n), kBlock, 0, stream>>>(op, e, a, b, out,
                                                            n);
  return cudaGetLastError();
}

// scratch: fr_barycentric_scratch_bytes(W) bytes
int64_t fr_barycentric_scratch_bytes(int W) {
  return (int64_t)((W + kTermsBlock - 1) / kTermsBlock) * sizeof(Fr);
}

int fr_barycentric_launch(const int32_t* poly, const int32_t* roots,
                          const int32_t* z, const int32_t* h_pow_w,
                          const int32_t* inv_scale, int W, void* scratch,
                          int32_t* out, cudaStream_t stream) {
  Fr* partial = (Fr*)scratch;
  const unsigned nb = (W + kTermsBlock - 1) / kTermsBlock;
  fr_barycentric_terms_kernel<<<nb, kTermsBlock, 0, stream>>>(poly, roots, z,
                                                              W, partial);
  int err = cudaGetLastError();
  if (err) return err;
  fr_barycentric_finish_kernel<<<1, kBlock, 0, stream>>>(
      partial, (int)nb, z, h_pow_w, inv_scale, W, out);
  return cudaGetLastError();
}

// scratch: fr_coset_scratch_bytes(B, Wd) bytes; Wd a power of two <= 256
int64_t fr_coset_scratch_bytes(int B, int Wd) {
  const int rows = kBlock / Wd;
  const int64_t nb = (B + rows - 1) / rows;
  return ((int64_t)2 * B * Wd + (int64_t)Wd * Wd + nb * Wd) * sizeof(Fr);
}

int fr_coset_interpolate_launch(const int32_t* evals, const int32_t* idft,
                                const int32_t* weights, int B, int Wd,
                                void* scratch, int32_t* out,
                                cudaStream_t stream) {
  const int rows = kBlock / Wd;
  const int nb = (B + rows - 1) / rows;
  Fr* ev = (Fr*)scratch;
  Fr* wt = ev + (int64_t)B * Wd;
  Fr* M = wt + (int64_t)B * Wd;
  Fr* partial = M + (int64_t)Wd * Wd;
  const int64_t n_ev = (int64_t)B * Wd, n_m = (int64_t)Wd * Wd;
  fr_load_kernel<<<blocks_for(n_ev), kBlock, 0, stream>>>(evals, n_ev, ev);
  fr_load_kernel<<<blocks_for(n_ev), kBlock, 0, stream>>>(weights, n_ev, wt);
  fr_load_kernel<<<blocks_for(n_m), kBlock, 0, stream>>>(idft, n_m, M);
  int err = cudaGetLastError();
  if (err) return err;
  fr_coset_fold_kernel<<<nb, rows * Wd, 0, stream>>>(ev, M, wt, B, Wd,
                                                     partial);
  err = cudaGetLastError();
  if (err) return err;
  fr_coset_finish_kernel<<<blocks_for(Wd), kBlock, 0, stream>>>(partial, nb,
                                                                Wd, out);
  return cudaGetLastError();
}

// scratch: fr_fft_scratch_bytes(batch, n) bytes; n a power of two >= 2
int64_t fr_fft_scratch_bytes(int batch, int n) {
  return ((int64_t)batch * n + n) * sizeof(Fr);
}

int fr_fft_launch(const int32_t* x, const int32_t* roots,
                  const int32_t* scale, int batch, int n, void* scratch,
                  int32_t* out, cudaStream_t stream) {
  const int64_t total = (int64_t)batch * n;
  Fr* xw = (Fr*)scratch;
  Fr* rw = xw + total;
  fr_load_kernel<<<blocks_for(total), kBlock, 0, stream>>>(x, total, xw);
  fr_load_kernel<<<blocks_for(n), kBlock, 0, stream>>>(roots, n, rw);
  int err = cudaGetLastError();
  if (err) return err;
  const int64_t n_bfly = total / 2;
  for (int h = 1; h < n; h *= 2) {
    fr_fft_stage_kernel<<<blocks_for(n_bfly), kBlock, 0, stream>>>(
        xw, rw, n, h, n_bfly);
    err = cudaGetLastError();
    if (err) return err;
  }
  fr_scale_store_kernel<<<blocks_for(total), kBlock, 0, stream>>>(
      xw, scale, total, out);
  return cudaGetLastError();
}

}  // extern "C"
