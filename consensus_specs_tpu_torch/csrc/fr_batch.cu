// Kernels K15-K18: the BLS12-381 scalar-field kernels of the KZG and DAS
// paths, over the device arithmetic of `fr.cuh`.
//
//   K15 fr_field_ops          fr_batch.py:48 PrimeFieldKernel: one of mul,
//                             add, sub, inv, pow (a fixed exponent), canon,
//                             elementwise, a thread an element; `inv` by
//                             the binary inversion (`fr_inv_binary`) on
//                             32-thread blocks spread over the SMs.  Its
//                             sibling launch `fr_batch_inverse` is
//                             Montgomery's trick over n elements in one
//                             cooperative launch (das/recover.py:110
//                             _batch_inverse): a thread an element (or a
//                             run), a product heap a block and one over
//                             the blocks, one binary inversion of its
//                             root, the heaps back down.  On the PeerDAS
//                             producer's path (FK20's scalars out of
//                             Montgomery form) and the recovery's (the
//                             decode's products and its batch inverse).
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
//                             Two launches.  A load launch stages the
//                             three inputs' limbs in shared memory and
//                             packs each into its value x 2^396 mod r
//                             (word planes, no product for canonical
//                             limbs).  Then a fold launch: a block a tile
//                             of rows b, columns j and inner indices i,
//                             its M and e tiles in shared memory; a
//                             thread a row of one column, its inner sum
//                             taken lazily as raw 512-bit products
//                             (8 x 8 word products, the carries counted
//                             apart) and reduced once, then weighted; the
//                             block sums its rows, and the last block to
//                             finish sums the blocks' partials.
//   K18 fr_fft                fr_batch.py:417 _fr_fft_kernel: the radix-2
//                             DIT FFT of a batch of rows given in
//                             bit-reversed order, natural-order out, times
//                             a scale (1/n for the inverse).  A tile
//                             launch: a block a tile of T contiguous
//                             elements of a row (T = min(kFftTile, n)),
//                             copied in as boundary limbs and converted in
//                             shared memory with the T/2 twiddles its
//                             stages read (roots[j n / T]), every stage
//                             h < T there.  A row that fits a tile is
//                             scaled and stored by that launch: one launch
//                             a call.  Otherwise the tile launch also
//                             converts roots[0 .. n/2) and a class launch
//                             runs the stages h >= T, where an element
//                             meets only the elements of its residue mod
//                             T: a group of threads a residue class, its
//                             n/T elements and their twiddles in shared
//                             memory, then the scale and the store in one
//                             product an element.  Two launches a call.
//
// Inputs and outputs are the port's boundary format (fr.cuh): (..., 33)
// int32 limbs, R = 2^396; outputs are canonical.  Sums are taken mod r
// in any order: the values are exact, so they equal the plain versions'
// (which follow JAX's order) at canonical values.
//
// What bounds them: the issue of the Fr products, not the bytes.  On the
// H100 a product takes about half a microsecond on one thread
// (`fr_product_chain`), and a warp with several in flight is hardly
// faster a product: one warp a scheduler all but fills its issue.  A
// conversion from the boundary limbs costs more than two products.  So a
// block spreads its work over an SM's four schedulers and a launch over as
// many SMs as it can fill.  K16's lanes each run the binary inversion
// (`mont_inv_binary`, 512 branch-free steps of word additions and shifts,
// in place of a 418-product Fermat chain) on 32-thread blocks; K17's
// threads the raw products of their sums (a product's 64 word products,
// but not its reduction) and one reduction an output; K18
// one product a stage a butterfly, log2 n stages in one or two launches
// (the first version launched once a stage, log2 n + 3 launches, through
// device memory); the batch inverse's chain is the
// heaps' depth both ways and the one inversion.  Every launcher returns
// the first non-zero cudaGetLastError() of its launches.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fr.cuh"

namespace cg = cooperative_groups;

namespace {

enum FrOp { OP_MUL = 0, OP_ADD, OP_SUB, OP_INV, OP_POW, OP_CANON };

struct FrExp { uint32_t w[FR_NW]; };

constexpr int kBlock = 256;
constexpr int kTermsBlock = 32;   // K16's terms launch, K15's inv
constexpr int kInvBlock = 256;    // K15's batch inverse: threads a block
constexpr int kInvBlocks = 256;   // its blocks, at most (block 0's heap)
constexpr int kFftTile = 128;     // K18's T: elements of a row a block holds
constexpr int kFftThreads = 128;  // K18's tile block
constexpr int kFftClass = 128;    // K18's class block
constexpr int kFftClassPer = 4;   // K18's class elements a thread, at most
constexpr int kCosetLoad = 256;   // K17's load block: elements a block
constexpr int kCosetThreads = 512;  // K17's fold block
constexpr int kCosetWidth = 256;  // K17's W, at most
constexpr int kCosetCols = 32;    // its column tile, at most
constexpr int kCosetInner = 64;   // its inner tile, at most
constexpr int kCosetMinInner = 4; // its inner tile, at least (W permitting)
constexpr int kCosetFill = 128;   // fold blocks aimed at: about one an SM
constexpr int kMaxShared = 232448;
constexpr int kMaxDevices = 64;

// Shared-memory staging (K15's batch inverse, K18): the (., 33) boundary
// rows are copied between device and shared memory a word a thread,
// neighbouring threads on neighbouring words (cp.async on the way in),
// and converted there: a row a thread reads its 33 words at a stride of
// 33, which spreads a warp over all 32 banks.  (A thread that loads its
// own row from device memory touches a line a word, and a warp's 33 loads
// then cost a line each.)
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ bool aligned16(const void* a, const void* b,
                                          int64_t words) {
  return ((((uintptr_t)a | (uintptr_t)b) & 15) | (words & 3)) == 0;
}

// words [0, count) of src (device) into dst (shared), all of the block's
// threads: 16 bytes a copy where both ends allow
__device__ __forceinline__ void copy_in(int32_t* dst, const int32_t* src,
                                       int64_t count) {
  if (aligned16(dst, src, count)) {
#pragma unroll 4
    for (int64_t f = threadIdx.x; f < count / 4; f += blockDim.x)
      cp_async16(dst + 4 * f, src + 4 * f);
  } else {
#pragma unroll 4
    for (int64_t f = threadIdx.x; f < count; f += blockDim.x)
      cp_async4(dst + f, src + f);
  }
}

// words [0, count) of src (shared) into dst (device), all of the block's
// threads
__device__ __forceinline__ void copy_out(int32_t* dst, const int32_t* src,
                                        int64_t count) {
  if (aligned16(dst, src, count)) {
#pragma unroll 4
    for (int64_t f = threadIdx.x; f < count / 4; f += blockDim.x)
      ((int4*)dst)[f] = ((const int4*)src)[f];
  } else {
#pragma unroll 4
    for (int64_t f = threadIdx.x; f < count; f += blockDim.x)
      dst[f] = src[f];
  }
}

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
    case OP_INV: fr_inv_binary(x, x); break;
    case OP_POW: fr_pow(x, x, e.w); break;
    default: break;
  }
  store_fr(out + i * FR_NL, x);
}

// Montgomery's trick over n elements in one cooperative launch of NB
// blocks of kInvBlock threads, GT = NB kInvBlock threads in all: thread gt
// takes the run j = gt + k GT (k < run), so that a block's threads take
// neighbouring elements at each k, whose rows it copies into shared memory
// a word a thread.  (A) Each thread keeps its elements and prefix
// products in xs and pre, its run's product is leaf t of its block's heap
// (tr[1] the root, tr[v] = tr[2v] tr[2v + 1]; no element: one), and the
// root goes to part[b].  (B) Block 0 builds the same heap over the NB
// block products, inverts its root (the one inversion), and walks down:
// node v's inverse is its parent's times its sibling's product, written
// over v a level at a time; part[b] becomes block b's inverse.  (C) Each
// block walks its own heap down from part[b]; each run walks back, out_j
// = inv pre_(j - GT) and inv *= x_j, its limbs staged in shared memory and
// copied out a word a thread.  A zero element makes a root 0 and so every
// output 0, as JAX's host `_batch_inverse`.
__device__ void heap_up(Fr* tr, int leaves) {
  const int t = threadIdx.x;
  for (int m = leaves / 2; m > 0; m /= 2) {
    if (t < m) fr_mul_call(tr[m + t], tr[2 * (m + t)], tr[2 * (m + t) + 1]);
    __syncthreads();
  }
}

// tr[1] holds the root's inverse on entry
__device__ void heap_down(Fr* tr, int leaves) {
  const int t = threadIdx.x;
  for (int m = 2; m <= leaves; m *= 2) {
    Fr v;
    if (t < m) fr_mul_call(v, tr[(m + t) / 2], tr[(m + t) ^ 1]);
    __syncthreads();
    if (t < m) tr[m + t] = v;
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kInvBlock)
fr_batch_inverse_kernel(const int32_t* __restrict__ a, int64_t n, int run,
                        Fr* __restrict__ xs, Fr* __restrict__ pre,
                        Fr* __restrict__ part, int32_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char fr_smem[];
  Fr* tr = (Fr*)fr_smem;                          // 2 kInvBlock
  Fr* top = tr + 2 * kInvBlock;                   // 2 kInvBlock
  int32_t* raw = (int32_t*)(top + 2 * kInvBlock); // kInvBlock rows
  cg::grid_group grid = cg::this_grid();
  const int t = threadIdx.x, B = blockDim.x, NB = gridDim.x;
  const int64_t GT = (int64_t)NB * B;
  auto rows_at = [&](int k, int64_t* r0) {
    *r0 = (int64_t)blockIdx.x * B + k * GT;
    const int64_t left = n - *r0;
    return left <= 0 ? 0 : (left < B ? (int)left : B);
  };
  Fr acc;
  mont_one(acc);
  for (int k = 0; k < run; ++k) {
    int64_t r0;
    const int rows = rows_at(k, &r0);
    if (rows == 0) break;
    copy_in(raw, a + r0 * FR_NL, (int64_t)rows * FR_NL);
    cp_async_wait();
    __syncthreads();
    if (t < rows) {
      Fr v;
      load_fr_call(v, raw + t * FR_NL);
      xs[r0 + t] = v;
      if (k == 0) acc = v; else fr_mul_call(acc, acc, v);
      pre[r0 + t] = acc;
    }
    __syncthreads();
  }
  tr[B + t] = acc;
  __syncthreads();
  heap_up(tr, B);
  if (t == 0) part[blockIdx.x] = tr[1];
  grid.sync();
  if (blockIdx.x == 0) {
    int leaves = 1;
    while (leaves < NB) leaves *= 2;
    if (t < leaves) {
      if (t < NB) top[leaves + t] = part[t]; else mont_one(top[leaves + t]);
    }
    __syncthreads();
    heap_up(top, leaves);
    if (t == 0) fr_inv_binary(top[1], top[1]);
    __syncthreads();
    heap_down(top, leaves);
    if (t < NB) part[t] = top[leaves + t];
  }
  grid.sync();
  if (t == 0) tr[1] = part[blockIdx.x];
  __syncthreads();
  heap_down(tr, B);
  Fr inv = tr[B + t], c_out;
  mont_from_const(c_out, FRC.c_out);
  for (int k = run - 1; k >= 0; --k) {
    int64_t r0;
    const int rows = rows_at(k, &r0);
    if (rows == 0) continue;
    if (t < rows) {
      Fr o = inv;
      if (k > 0) {
        fr_mul_call(o, inv, pre[r0 + t - GT]);
        fr_mul_call(inv, inv, xs[r0 + t]);
      }
      store_fr_times_call(raw + t * FR_NL, o, c_out);
    }
    __syncthreads();
    int32_t* dst = out + r0 * FR_NL;
    copy_out(dst, raw, (int64_t)rows * FR_NL);
    __syncthreads();
  }
}

// a^(2^n) by n dependent products on one thread: the product's latency
__global__ void fr_product_chain_kernel(const int32_t* __restrict__ a, int n,
                                        int32_t* __restrict__ out) {
  Fr x;
  load_fr(x, a);
  for (int i = 0; i < n; ++i) fr_mul(x, x, x);
  store_fr(out, x);
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

// boundary limbs -> their value x 2^396 mod r, canonical: the packed words
// reduced where the limbs' value lies in [0, 2^256) (canonical limbs: no
// product), else a load and a product by c_out
__device__ __forceinline__ void fr_packed(Fr& out, const int32_t* src) {
  uint32_t w[MONT_LW];
  const int64_t carry = mont_pack(w, src);
  uint32_t high = (uint32_t)carry | (uint32_t)(carry >> 32);
#pragma unroll
  for (int j = FR_NW; j < MONT_LW; ++j) high |= w[j];
  if (high == 0) {
    mont_reduce_once(out, w, 0);          // < 2^256 < 3r
    mont_reduce_once(out, out.w, 0);
    return;
  }
  Fr c;
  load_fr_call(out, src);
  mont_from_const(c, FRC.c_out);
  fr_mul_call(out, out, c);
}

// acc (16 words) += a b, the carry out of each row's chain counted in cy
// (cy[m] at word m + 8): a row is 8 multiply-adds of the low halves and
// 8 of the high halves, each one PTX carry chain (which ptxas turns into
// an IMAD and an IADD3.X a word product); no reduction a product.
__device__ __forceinline__ void lazy_mad(uint32_t* acc, uint32_t* cy,
                                         const uint32_t* a, const uint32_t* b) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    asm("mad.lo.cc.u32 %0, %9, %10, %0;\n\t"
        "madc.lo.cc.u32 %1, %9, %11, %1;\n\t"
        "madc.lo.cc.u32 %2, %9, %12, %2;\n\t"
        "madc.lo.cc.u32 %3, %9, %13, %3;\n\t"
        "madc.lo.cc.u32 %4, %9, %14, %4;\n\t"
        "madc.lo.cc.u32 %5, %9, %15, %5;\n\t"
        "madc.lo.cc.u32 %6, %9, %16, %6;\n\t"
        "madc.lo.cc.u32 %7, %9, %17, %7;\n\t"
        "addc.u32 %8, %8, 0;"
        : "+r"(acc[i]), "+r"(acc[i + 1]), "+r"(acc[i + 2]), "+r"(acc[i + 3]),
          "+r"(acc[i + 4]), "+r"(acc[i + 5]), "+r"(acc[i + 6]),
          "+r"(acc[i + 7]), "+r"(cy[i])
        : "r"(a[i]), "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]),
          "r"(b[5]), "r"(b[6]), "r"(b[7]));
    asm("mad.hi.cc.u32 %0, %9, %10, %0;\n\t"
        "madc.hi.cc.u32 %1, %9, %11, %1;\n\t"
        "madc.hi.cc.u32 %2, %9, %12, %2;\n\t"
        "madc.hi.cc.u32 %3, %9, %13, %3;\n\t"
        "madc.hi.cc.u32 %4, %9, %14, %4;\n\t"
        "madc.hi.cc.u32 %5, %9, %15, %5;\n\t"
        "madc.hi.cc.u32 %6, %9, %16, %6;\n\t"
        "madc.hi.cc.u32 %7, %9, %17, %7;\n\t"
        "addc.u32 %8, %8, 0;"
        : "+r"(acc[i + 1]), "+r"(acc[i + 2]), "+r"(acc[i + 3]),
          "+r"(acc[i + 4]), "+r"(acc[i + 5]), "+r"(acc[i + 6]),
          "+r"(acc[i + 7]), "+r"(acc[i + 8]), "+r"(cy[i + 1])
        : "r"(a[i]), "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]),
          "r"(b[5]), "r"(b[6]), "r"(b[7]));
  }
}

// V = acc + sum cy[m] 2^(32 (m + 8)), a sum of at most 2^31 products of
// values below 2^256 -> V 2^-256 mod r, canonical.  The word above 2^512
// is folded in twice as its multiple of c_top = 2^512 mod r (the second
// time a bit at most), leaving V < 2^512; a Montgomery reduction then
// gives (V + m r) / 2^256 < 2^256 + r < 4r, and three conditional
// subtractions the canonical value.
__device__ __noinline__ void lazy_reduce(Fr& out, const uint32_t* acc,
                                         const uint32_t* cy) {
  uint32_t v[17];
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = acc[j];
#pragma unroll
  for (int j = 8; j < 16; ++j) {
    c += (uint64_t)acc[j] + cy[j - 8];
    v[j] = (uint32_t)c;
    c >>= 32;
  }
  v[16] = (uint32_t)c + cy[8];
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    const uint32_t h = v[16];
    c = 0;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      c += (uint64_t)v[j] + (j < 8 ? (uint64_t)h * FRC.c_top[j] : 0);
      v[j] = (uint32_t)c;
      c >>= 32;
    }
    v[16] = (uint32_t)c;
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const uint32_t m = v[k] * FRC.n0;
    c = 0;
#pragma unroll
    for (int j = 0; j < 17 - k; ++j) {
      c += (uint64_t)v[k + j] + (j < 8 ? (uint64_t)m * FRC.mod[j] : 0);
      v[k + j] = (uint32_t)c;
      c >>= 32;
    }
  }
#pragma unroll
  for (int pass = 0; pass < 3; ++pass) {
    uint32_t d[9], borrow = 0;
#pragma unroll
    for (int j = 0; j < 9; ++j) {
      const uint64_t t = (uint64_t)v[8 + j] - (j < 8 ? FRC.mod[j] : 0) - borrow;
      d[j] = (uint32_t)t;
      borrow = (uint32_t)(t >> 63);
    }
#pragma unroll
    for (int j = 0; j < 9; ++j) v[8 + j] = borrow ? v[8 + j] : d[j];
  }
#pragma unroll
  for (int j = 0; j < FR_NW; ++j) out.w[j] = v[8 + j];
}

// The load launch: block b converts elements [b kCosetLoad, ..) of one
// input (evals, then weights, then idft), their rows copied into shared
// memory a word a thread; word k of element e goes to plane k (dst[k n +
// e]), so that the fold's copies and reads are contiguous.  Block 0 also
// clears the fold's counter.
__global__ void __launch_bounds__(kCosetLoad)
fr_coset_load_kernel(const int32_t* __restrict__ ev, const int32_t* __restrict__ wt,
                     const int32_t* __restrict__ M, int64_t n_ev, int64_t n_m,
                     uint32_t* __restrict__ planes, unsigned* __restrict__ done) {
  extern __shared__ __align__(16) unsigned char fr_smem[];
  int32_t* raw = (int32_t*)fr_smem;
  const int64_t per_ev = (n_ev + kCosetLoad - 1) / kCosetLoad;
  int64_t blk = blockIdx.x;
  const int32_t* src = ev;
  uint32_t* dst = planes;
  int64_t n = n_ev;
  if (blk >= per_ev) {
    blk -= per_ev;
    src = wt;
    dst += FR_NW * n_ev;
    if (blk >= per_ev) {
      blk -= per_ev;
      src = M;
      dst += FR_NW * n_ev;
      n = n_m;
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) *done = 0;
  const int64_t e0 = blk * kCosetLoad;
  const int rows = n - e0 < kCosetLoad ? (int)(n - e0) : kCosetLoad;
  copy_in(raw, src + e0 * FR_NL, (int64_t)rows * FR_NL);
  cp_async_wait();
  __syncthreads();
  const int t = threadIdx.x;
  if (t >= rows) return;
  Fr x;
  fr_packed(x, raw + t * FR_NL);
#pragma unroll
  for (int k = 0; k < FR_NW; ++k) dst[k * n + e0 + t] = x.w[k];
}

__device__ __forceinline__ Fr load_cg(const Fr* p) {
  const uint4 a = __ldcg((const uint4*)p), b = __ldcg((const uint4*)p + 1);
  Fr x;
  x.w[0] = a.x; x.w[1] = a.y; x.w[2] = a.z; x.w[3] = a.w;
  x.w[4] = b.x; x.w[5] = b.y; x.w[6] = b.z; x.w[7] = b.w;
  return x;
}

// The fold launch over the planes of the load launch (values v = x 2^396):
// block (bb, jb, c) takes rows b0 = bb tb .. + tb, columns j0 = jb tj ..
// + tj and inner indices i0 = c ic .. + ic, M's tile (word k, row i,
// column j at k ic tj + i tj + j) and e's (row b at k tb es + b es, es
// = ic + 4) copied into shared memory.  Thread (pr, jl) takes row pr of
// column jl: acc = sum_i v(e) v(M) = 2^792 sum_i e M, reduced once
// (2^536 sum_i e M), times v(w) by a Montgomery product (2^676 w sum_i
// e M); then the block's rows are summed.  The partial of each column goes to partial[(bb ict + c) W +
// j]; the last block to finish (a counter, after a fence) sums a column's
// partials on kCosetThreads / W threads and a tree, and two products by
// c_lo (2^-140 each) and the store give S_j's canonical limbs.  Rows past
// B read 0.
__global__ void __launch_bounds__(kCosetThreads)
fr_coset_fold_kernel(const uint32_t* __restrict__ planes, int B, int W, int tj,
                     int tb, int ic, Fr* __restrict__ partial,
                     unsigned* __restrict__ done, int32_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char fr_smem[];
  __shared__ int last;
  const int64_t n_ev = (int64_t)B * W;
  const uint32_t* ev = planes;
  const uint32_t* wt = planes + FR_NW * n_ev;
  const uint32_t* M = wt + FR_NW * n_ev;
  const int lj = __ffs(tj) - 1, li = __ffs(ic) - 1, lb = __ffs(tb) - 1;
  const int jt = W >> lj, ict = W >> li, es = ic + 4;
  int blk = blockIdx.x;
  const int c = blk % ict;
  blk /= ict;
  const int jb = blk % jt, bb = blk / jt;
  const int b0 = bb * tb, j0 = jb * tj, i0 = c * ic;
  uint32_t* sm = (uint32_t*)fr_smem;
  uint32_t* se = sm + FR_NW * ic * tj;
  const int t = threadIdx.x;
  if ((tj & 3) == 0 && (ic & 3) == 0) {   // 16-byte copies
    const int qm = FR_NW * ic * tj / 4, qe = FR_NW * tb * ic / 4;
    for (int f = t; f < qm; f += blockDim.x) {
      const int w = 4 * f, k = w >> (li + lj), i = (w >> lj) & (ic - 1);
      cp_async16(sm + w, M + (int64_t)k * W * W + (int64_t)(i0 + i) * W + j0 +
                              (w & (tj - 1)));
    }
    for (int f = t; f < qe; f += blockDim.x) {
      const int w = 4 * f, k = w >> (lb + li), b = (w >> li) & (tb - 1);
      uint32_t* d = se + (k * tb + b) * es + (w & (ic - 1));
      if (b0 + b < B)
        cp_async16(d, ev + k * n_ev + (int64_t)(b0 + b) * W + i0 + (w & (ic - 1)));
      else
        *(uint4*)d = make_uint4(0, 0, 0, 0);
    }
  } else {
    for (int w = t; w < FR_NW * ic * tj; w += blockDim.x) {
      const int k = w >> (li + lj), i = (w >> lj) & (ic - 1);
      cp_async4(sm + w, M + (int64_t)k * W * W + (int64_t)(i0 + i) * W + j0 +
                            (w & (tj - 1)));
    }
    for (int w = t; w < FR_NW * tb * ic; w += blockDim.x) {
      const int k = w >> (lb + li), b = (w >> li) & (tb - 1);
      uint32_t* d = se + (k * tb + b) * es + (w & (ic - 1));
      if (b0 + b < B)
        cp_async4(d, ev + k * n_ev + (int64_t)(b0 + b) * W + i0 + (w & (ic - 1)));
      else
        *d = 0;
    }
  }
  cp_async_wait();
  __syncthreads();

  // a thread has one carry flag, so a second row's chains would only
  // queue behind the first's (two rows a thread, 256 threads a block,
  // were 6% slower): latency is hidden by the block's other warps
  const int jl = t & (tj - 1), pr = t >> lj;
  const uint32_t* m_col = sm + jl;
  const uint32_t* e_row = se + pr * es;
  uint32_t sums[16], cy[9];
#pragma unroll
  for (int k = 0; k < 16; ++k) sums[k] = 0;
#pragma unroll
  for (int k = 0; k < 9; ++k) cy[k] = 0;
  for (int i = 0; i < ic; ++i) {
    uint32_t m[FR_NW], x[FR_NW];
#pragma unroll
    for (int k = 0; k < FR_NW; ++k) {
      m[k] = m_col[(k * ic + i) * tj];
      x[k] = e_row[k * tb * es + i];
    }
    lazy_mad(sums, cy, x, m);
  }
  const int j = j0 + jl, r0 = b0 + pr;
  Fr s0, w;
  lazy_reduce(s0, sums, cy);
#pragma unroll
  for (int k = 0; k < FR_NW; ++k)
    w.w[k] = r0 < B ? wt[k * n_ev + (int64_t)r0 * W + j] : 0;
  fr_mul_call(s0, s0, w);
  __syncthreads();                        // the tiles are read
  Fr* red = (Fr*)fr_smem;
  red[t] = s0;
  __syncthreads();
  for (int h = (int)(blockDim.x >> lj) / 2; h > 0; h >>= 1) {
    if (pr < h) fr_add(red[t], red[t], red[t + h * tj]);
    __syncthreads();
  }
  if (pr == 0) partial[(int64_t)(bb * ict + c) * W + j] = red[jl];
  __threadfence();
  __syncthreads();
  if (t == 0) last = atomicAdd(done, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int n_parts = (int)gridDim.x / jt, G = blockDim.x / W;
  const int jj = t & (W - 1), g = t / W;
  Fr acc;
  fr_zero(acc);
  if (g < G)
    for (int p = g; p < n_parts; p += G)
      fr_add(acc, acc, load_cg(partial + (int64_t)p * W + jj));
  red[t] = acc;
  __syncthreads();
  for (int h = G / 2; h > 0; h >>= 1) {
    if (g < h) fr_add(red[t], red[t], red[t + h * W]);
    __syncthreads();
  }
  int32_t* raw = (int32_t*)(red + blockDim.x);
  if (g == 0) {
    Fr k, x = red[jj];
    mont_from_const(k, FRC.c_lo);
    fr_mul_call(x, x, k);
    store_fr_times_call(raw + jj * FR_NL, x, k);
  }
  __syncthreads();
  copy_out(out, raw, (int64_t)W * FR_NL);
}

// --- K18 -------------------------------------------------------------------

// Elements in shared memory word-major (word w of element e at
// w[w * stride + e]), so that a warp reading neighbouring elements reads
// neighbouring words.
struct FrCols {
  uint32_t* w;
  int stride;
  __device__ __forceinline__ Fr get(int e) const {
    Fr x;
#pragma unroll
    for (int j = 0; j < FR_NW; ++j) x.w[j] = w[j * stride + e];
    return x;
  }
  __device__ __forceinline__ void put(int e, const Fr& x) const {
#pragma unroll
    for (int j = 0; j < FR_NW; ++j) w[j * stride + e] = x.w[j];
  }
};

// k = mont(scale R, c_out) = scale 2^396 mod r, so that
// store_fr_times_call(., x, k) stores x scale.  That is the value of the
// scale's boundary limbs: for canonical limbs their packed words, else the
// load and a product.
__device__ __forceinline__ Fr fft_store_factor(const int32_t* scale) {
  uint32_t w[MONT_LW];
  const int64_t carry = mont_pack(w, scale);
  uint32_t high = (uint32_t)carry, borrow = 0;
  Fr k;
#pragma unroll
  for (int j = 0; j < FR_NW; ++j) {
    k.w[j] = w[j];
    const uint64_t d = (uint64_t)w[j] - FRC.mod[j] - borrow;
    borrow = (uint32_t)(d >> 63);
  }
#pragma unroll
  for (int j = FR_NW; j < MONT_LW; ++j) high |= w[j];
  if (high == 0 && borrow) return k;        // packed words < r
  Fr c;
  load_fr_call(k, scale);
  mont_from_const(c, FRC.c_out);
  fr_mul_call(k, k, c);
  return k;
}

// The tile launch: block b holds elements [t0, t0 + tile) of row b / (n /
// tile), t0 = (b mod (n / tile)) tile, in shared memory beside the tile/2
// twiddles its stages read: stage h's twiddle i is roots[i n / (2h)] =
// tw[i tile / (2h)], tw[j] = roots[j n / tile].  The block's kFftThreads
// threads share the conversions, the butterflies of a stage and the
// stores: every step is issue-bound (see above), so a tile spreads its
// work over an SM's four schedulers.  With `final_` the tile is the whole
// row and leaves scaled, as boundary limbs (staged in shared memory,
// copied out a word a thread).  Otherwise it leaves as Montgomery words in
// xw; row 0's tiles also convert roots[0 .. n/2) into rw for the class
// launch, tile/2 each.  Shared memory holds the tile's rows beside the
// twiddles' (and rw's).
__global__ void __launch_bounds__(kFftThreads)
fr_fft_tile_kernel(const int32_t* __restrict__ x,
                   const int32_t* __restrict__ roots,
                   const int32_t* __restrict__ scale, int n, int tile,
                   int final_, Fr* __restrict__ xw, Fr* __restrict__ rw,
                   int32_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char fr_smem[];
  const int tiles = n / tile, half = tile / 2;
  const FrCols s{(uint32_t*)fr_smem, tile};
  const FrCols tw{s.w + FR_NW * tile, half};
  int32_t* raw = (int32_t*)(tw.w + FR_NW * half);
  const int64_t row = blockIdx.x / tiles;
  const int t0 = (blockIdx.x % tiles) * tile;
  const int64_t base = row * n + t0;
  // rows to convert, x's then the twiddles' (then rw's, on row 0)
  const int jobs = tile + (!final_ && row == 0 ? tile : half);
  copy_in(raw, x + base * FR_NL, (int64_t)tile * FR_NL);
  int32_t* const raw_tw = raw + tile * FR_NL;
#pragma unroll 4
  for (int f = threadIdx.x; f < half * FR_NL; f += blockDim.x) {
    const int j = f / FR_NL, l = f - j * FR_NL;
    cp_async4(raw_tw + f, roots + ((int64_t)j * tiles) * FR_NL + l);
  }
  if (jobs > tile + half)
    copy_in(raw_tw + half * FR_NL, roots + (int64_t)(t0 / 2) * FR_NL,
            (int64_t)half * FR_NL);
  Fr k;
  if (final_) k = fft_store_factor(scale);   // while the copies run
  cp_async_wait();
  __syncthreads();
  for (int j = threadIdx.x; j < jobs; j += blockDim.x) {
    Fr v;
    load_fr_call(v, raw + j * FR_NL);
    if (j < tile) s.put(j, v);
    else if (j < tile + half) tw.put(j - tile, v);
    else rw[t0 / 2 + j - tile - half] = v;
  }
  __syncthreads();
  for (int h = 1; h < tile; h *= 2) {
    const int step = half / h;
    for (int b = threadIdx.x; b < half; b += blockDim.x) {
      const int i = b & (h - 1), e = 2 * b - i;       // (b / h) 2h + i
      const Fr u = s.get(e);
      Fr v, r;
      fr_mul(v, s.get(e + h), tw.get(i * step));
      fr_add(r, u, v);
      s.put(e, r);
      fr_sub(r, u, v);
      s.put(e + h, r);
    }
    __syncthreads();
  }
  if (!final_) {
    for (int i = threadIdx.x; i < tile; i += blockDim.x) xw[base + i] = s.get(i);
    return;
  }
  for (int i = threadIdx.x; i < tile; i += blockDim.x)
    store_fr_times_call(raw + i * FR_NL, s.get(i), k);
  __syncthreads();
  int32_t* dst = out + base * FR_NL;
  copy_out(dst, raw, (int64_t)tile * FR_NL);
}

// The class launch, stages h = tile .. n/2: element e meets only the
// elements of its residue c = e mod tile, the m = n / tile elements
// c + tile q.  A block holds G neighbouring classes (G m / 2 butterflies
// over its threads, a class's in the threads g, g + G, ..), element q of
// class g at index q G + g, so that neighbouring threads read neighbouring
// words.  Stage h' = h / tile pairs q and q + h' with twiddle roots[i n /
// (2h)], i = c + tile i', i' = q mod h': rw[(c + tile i') m / (2h')],
// which the block copies into shared memory first (entry (h' - 1 + i') G
// + g), beside its elements.  Then each element
// is scaled and stored in one product, its limbs staged in shared memory
// and copied out a word a thread (the G rows of a q are neighbours).  A
// thread holds at most kFftClassPer elements.
__global__ void __launch_bounds__(kFftClass)
fr_fft_class_kernel(const Fr* __restrict__ xw, const Fr* __restrict__ rw,
                    const int32_t* __restrict__ scale, int n, int tile, int G,
                    int32_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char fr_smem[];
  const int m = n / tile, half = m / 2, per_row = tile / G;
  const FrCols s{(uint32_t*)fr_smem, m * G};
  const FrCols tws{s.w + FR_NW * m * G, (m - 1) * G};
  int32_t* raw = (int32_t*)(tws.w + FR_NW * (m - 1) * G);
  const int64_t row = blockIdx.x / per_row;
  const int g = threadIdx.x % G, p = threadIdx.x / G;
  const int P = blockDim.x / G;                    // threads a class
  const int c0 = (blockIdx.x % per_row) * G;
  const int64_t base = row * n + c0 + g;
  Fr a[kFftClassPer];
#pragma unroll
  for (int r = 0; r < kFftClassPer; ++r) {
    const int q = p + r * P;
    if (q < m) a[r] = xw[base + (int64_t)q * tile];
  }
  const Fr k = fft_store_factor(scale);           // while the loads run
  for (int f = threadIdx.x; f < (m - 1) * G; f += blockDim.x) {
    const int idx = f / G, gg = f - idx * G;
    const int hp = 1 << (31 - __clz(idx + 1)), ip = idx + 1 - hp;
    tws.put(f, rw[(int64_t)(c0 + gg + tile * ip) * (half / hp)]);
  }
#pragma unroll
  for (int r = 0; r < kFftClassPer; ++r) {
    const int q = p + r * P;
    if (q < m) s.put(q * G + g, a[r]);
  }
  __syncthreads();
  for (int h = 1; h < m; h *= 2) {
    for (int b = p; b < half; b += P) {
      const int i = b & (h - 1), q = 2 * b - i;
      const Fr u = s.get(q * G + g);
      Fr v, r;
      fr_mul(v, s.get((q + h) * G + g), tws.get((h - 1 + i) * G + g));
      fr_add(r, u, v);
      s.put(q * G + g, r);
      fr_sub(r, u, v);
      s.put((q + h) * G + g, r);
    }
    __syncthreads();
  }
  for (int q = p; q < m; q += P)
    store_fr_times_call(raw + (q * G + g) * FR_NL, s.get(q * G + g), k);
  __syncthreads();
  // a q's G rows are neighbours in `out`: G 33 words, a multiple of 4
  // (16-byte stores) where G is
  const int span = G % 4 ? G * FR_NL : G * FR_NL / 4;
  int32_t* dst = out + (row * n + c0) * FR_NL;
#pragma unroll 4
  for (int f = threadIdx.x; f < m * span; f += blockDim.x) {
    const int q = f / span, l = f - q * span;
    if (G % 4)
      dst[(int64_t)q * tile * FR_NL + l] = raw[f];
    else
      ((int4*)(dst + (int64_t)q * tile * FR_NL))[l] = ((const int4*)raw)[f];
  }
}

// classes a class block holds: kFftClass / (m / 2), at least 1, at most
// the tile
int fft_classes(int n, int tile) {
  const int half = n / tile / 2;
  int G = half >= kFftClass ? 1 : kFftClass / half;
  return G < tile ? G : tile;
}

// the tile launch's shared memory: the tile and its twiddles as words,
// the tile's rows and the twiddles' (and rw's) rows beside them
size_t fft_tile_shared(int tile, bool final_) {
  const size_t rows = tile + (final_ ? tile / 2 : tile);
  return (size_t)(tile + tile / 2) * sizeof(Fr) + rows * FR_NL * 4;
}

// the class launch's: its elements, their twiddles, their rows
size_t fft_class_shared(int n, int tile, int G) {
  const int m = n / tile;
  return (size_t)G * (2 * m - 1) * sizeof(Fr) + (size_t)G * m * FR_NL * 4;
}

// K17's fold tiles: tj columns, tb = kCosetThreads / tj rows (one a
// thread), ic inner indices, halved from min(W, kCosetInner) down to
// kCosetMinInner while the blocks fall short of kCosetFill
struct CosetShape {
  int tj, tb, ic, jt;
  int64_t blocks;
};

CosetShape coset_shape(int B, int W) {
  CosetShape c;
  c.tj = W < kCosetCols ? W : kCosetCols;
  c.tb = kCosetThreads / c.tj;
  c.jt = W / c.tj;
  const int64_t tiles = (int64_t)((B + c.tb - 1) / c.tb) * c.jt;
  c.ic = W < kCosetInner ? W : kCosetInner;
  while (c.ic > kCosetMinInner && tiles * (W / c.ic) < kCosetFill) c.ic /= 2;
  c.blocks = tiles * (W / c.ic);
  return c;
}

// the fold's shared memory: its tiles, or the last block's sums and
// output rows, whichever is more
size_t coset_shared(const CosetShape& c) {
  const size_t tiles = (size_t)FR_NW * 4 * (c.ic * c.tj + c.tb * (c.ic + 4));
  const size_t sums = (size_t)kCosetThreads * sizeof(Fr) + kCosetWidth * FR_NL * 4;
  return tiles > sums ? tiles : sums;
}

unsigned blocks_for(int64_t n) {
  return (unsigned)((n + kBlock - 1) / kBlock);
}

// Host state kept per device, so that a launch asks the runtime nothing
// twice: the dynamic shared memory each kernel has been allowed there
// (cudaFuncSetAttribute) and the batch inverse's co-resident blocks.
int tile_allowed[kMaxDevices], class_allowed[kMaxDevices];
int coset_allowed[kMaxDevices];
int inv_allowed[kMaxDevices], inv_blocks_cap[kMaxDevices];

int current_device(int* dev) {
  const int err = cudaGetDevice(dev);
  if (err) return err;
  return *dev < kMaxDevices ? 0 : cudaErrorInvalidDevice;
}

// allow `kernel` shm bytes of dynamic shared memory on the current device,
// once a device and size; allowed[dev] holds what it has been given
template <typename K>
int allow_shared(K kernel, int* allowed, size_t shm) {
  int dev = 0;
  int err = current_device(&dev);
  if (err || allowed[dev] >= (int)shm) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)shm);
  if (!err) allowed[dev] = (int)shm;
  return err;
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
  const int threads = op == OP_INV ? kTermsBlock : kBlock;
  fr_field_ops_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0,
                        stream>>>(op, e, a, b, out, n);
  return cudaGetLastError();
}

size_t batch_inverse_shared() {
  return 4 * kInvBlock * sizeof(Fr) + (size_t)kInvBlock * FR_NL * 4;
}

// the batch inverse's blocks: one element a thread, at most kInvBlocks
// and the co-resident blocks (asked once a device); past that, runs
int fr_batch_inverse_blocks(int64_t n, int* blocks) {
  int dev = 0;
  int err = current_device(&dev);
  if (!err) err = allow_shared(fr_batch_inverse_kernel, inv_allowed,
                               batch_inverse_shared());
  if (err) return err;
  if (inv_blocks_cap[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (!err) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fr_batch_inverse_kernel, kInvBlock, batch_inverse_shared());
    if (err) return err;
    const int cap = per_sm * sms;
    inv_blocks_cap[dev] = cap < kInvBlocks ? cap : kInvBlocks;
  }
  int64_t nb = (n + kInvBlock - 1) / kInvBlock;
  if (nb > inv_blocks_cap[dev]) nb = inv_blocks_cap[dev];
  *blocks = nb < 1 ? 1 : (int)nb;
  return 0;
}

// scratch: fr_batch_inverse_scratch_bytes(n) bytes
int64_t fr_batch_inverse_scratch_bytes(int64_t n) {
  return (2 * n + kInvBlocks) * (int64_t)sizeof(Fr);
}

// a thread a run of ceil(n / (blocks kInvBlock)) elements
int fr_batch_inverse_launch(const int32_t* a, int64_t n, void* scratch,
                            int32_t* out, cudaStream_t stream) {
  if (n < 1) return cudaErrorInvalidValue;
  int nb = 0;
  int err = fr_batch_inverse_blocks(n, &nb);
  if (err) return err;
  const int64_t gt = (int64_t)nb * kInvBlock;
  int runs = (int)((n + gt - 1) / gt);
  Fr* xs = (Fr*)scratch;
  Fr* pre = xs + n;
  Fr* part = pre + n;
  void* args[] = {(void*)&a, (void*)&n, (void*)&runs, (void*)&xs,
                  (void*)&pre, (void*)&part, (void*)&out};
  err = cudaLaunchCooperativeKernel((const void*)fr_batch_inverse_kernel,
                                    dim3(nb), dim3(kInvBlock), args,
                                    batch_inverse_shared(), stream);
  if (err) return err;
  return cudaGetLastError();
}

int fr_product_chain_launch(const int32_t* a, int n, int32_t* out,
                            cudaStream_t stream) {
  fr_product_chain_kernel<<<1, 1, 0, stream>>>(a, n, out);
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

// scratch: fr_coset_scratch_bytes(B, Wd) bytes; Wd a power of two <= kCosetWidth:
// the three inputs' word planes, the fold's partials, its counter
int64_t fr_coset_scratch_bytes(int B, int Wd) {
  const CosetShape c = coset_shape(B, Wd);
  return ((int64_t)2 * B * Wd + (int64_t)Wd * Wd) * sizeof(Fr) +
         c.blocks / c.jt * Wd * (int64_t)sizeof(Fr) + 16;
}

int fr_coset_interpolate_launch(const int32_t* evals, const int32_t* idft,
                                const int32_t* weights, int B, int Wd,
                                void* scratch, int32_t* out,
                                cudaStream_t stream) {
  if (B < 1 || Wd < 1 || (Wd & (Wd - 1)) || Wd > kCosetWidth)
    return cudaErrorInvalidValue;
  const CosetShape c = coset_shape(B, Wd);
  const int64_t n_ev = (int64_t)B * Wd, n_m = (int64_t)Wd * Wd;
  uint32_t* planes = (uint32_t*)scratch;
  Fr* partial = (Fr*)(planes + FR_NW * (2 * n_ev + n_m));
  unsigned* done = (unsigned*)(partial + c.blocks / c.jt * Wd);
  const int64_t loads = 2 * ((n_ev + kCosetLoad - 1) / kCosetLoad) +
                        (n_m + kCosetLoad - 1) / kCosetLoad;
  const size_t shm_load = (size_t)kCosetLoad * FR_NL * 4;
  fr_coset_load_kernel<<<(unsigned)loads, kCosetLoad, shm_load, stream>>>(
      evals, weights, idft, n_ev, n_m, planes, done);
  int err = cudaGetLastError();
  if (err) return err;
  const size_t shm = coset_shared(c);
  err = allow_shared(fr_coset_fold_kernel, coset_allowed, shm);
  if (err) return err;
  fr_coset_fold_kernel<<<(unsigned)c.blocks, kCosetThreads, shm, stream>>>(
      planes, B, Wd, c.tj, c.tb, c.ic, partial, done, out);
  return cudaGetLastError();
}

// scratch: fr_fft_scratch_bytes(batch, n) bytes: the rows and roots[0 ..
// n/2) as Montgomery words between the two launches, none for a row that
// fits a tile
int64_t fr_fft_scratch_bytes(int batch, int n) {
  if (n <= kFftTile) return 0;
  return ((int64_t)batch * n + n / 2) * sizeof(Fr);
}

// n a power of two, 2 <= n <= kFftTile kFftClass kFftClassPer
int fr_fft_launch(const int32_t* x, const int32_t* roots,
                  const int32_t* scale, int batch, int n, void* scratch,
                  int32_t* out, cudaStream_t stream) {
  if (n < 2 || (n & (n - 1)) || batch < 1) return cudaErrorInvalidValue;
  const int T = n < kFftTile ? n : kFftTile;
  const bool final_ = n == T;
  if (!final_ && n / T > kFftClass * kFftClassPer)
    return cudaErrorInvalidValue;
  const size_t shm = fft_tile_shared(T, final_);
  if (shm > (size_t)kMaxShared) return cudaErrorInvalidValue;
  int err = allow_shared(fr_fft_tile_kernel, tile_allowed, shm);
  if (err) return err;
  const unsigned blocks = (unsigned)((int64_t)batch * (n / T));
  if (final_) {
    fr_fft_tile_kernel<<<blocks, kFftThreads, shm, stream>>>(
        x, roots, scale, n, T, 1, nullptr, nullptr, out);
    return cudaGetLastError();
  }
  Fr* xw = (Fr*)scratch;
  Fr* rw = xw + (int64_t)batch * n;
  fr_fft_tile_kernel<<<blocks, kFftThreads, shm, stream>>>(
      x, roots, nullptr, n, T, 0, xw, rw, nullptr);
  err = cudaGetLastError();
  if (err) return err;
  const int G = fft_classes(n, T), m = n / T;
  const int per = m / 2 < kFftClass ? m / 2 : kFftClass;
  const size_t shm2 = fft_class_shared(n, T, G);
  if (shm2 > (size_t)kMaxShared) return cudaErrorInvalidValue;
  err = allow_shared(fr_fft_class_kernel, class_allowed, shm2);
  if (err) return err;
  fr_fft_class_kernel<<<(unsigned)((int64_t)batch * (T / G)), G * per, shm2,
                        stream>>>(xw, rw, scale, n, T, G, out);
  return cudaGetLastError();
}

}  // extern "C"
