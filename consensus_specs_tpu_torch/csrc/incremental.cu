// K4, K5 and K6: the kernels of the incremental Merkle forest
// (consensus_specs_tpu_torch/parallel/incremental.py).
//
// A forest keeps every level of one SSZ list's data tree: level 0 holds
// the 2**depth leaf chunks, level k the 2**(depth-k) nodes above them,
// each node 8 big-endian uint32 words (two uint4).  Indices are int64 and
// are read as unsigned, so a negative index is out of range like any
// index >= the level's size.
//
// K4 replaces consensus_specs_tpu/parallel/incremental.py:122
// _update_dirty_impl on its sparse levels (the dense tail is K2 over the
// whole level, sha256.cu):
//   - leaf_scatter: level0[idx[i]] = words[i], dropping idx[i] >= 2**depth
//     (the sentinel of a padded dirty set);
//   - update_level: one sparse level, parent = idx[i] >> shift: hash the
//     pair of children (2 parent, 2 parent + 1) and write the parent,
//     dropping parent >= the level's size.  One thread per dirty lane,
//     one launch per level; stream order makes each level see the writes
//     of the level below.  Two lanes with one parent read the same pair
//     and write the same 32 bytes (a benign race, as JAX's scatter relies
//     on the same idempotence).  A dropped lane returns before it hashes;
//     JAX hashes the clamped pair and drops the result, so the written
//     nodes are the same.
// Bound on an H100: integer issue, as K2 (about 2,300 32-bit integer
// instructions per message against 104 bytes moved per lane).
//
// K5 replaces incremental.py:755 _gather_balance_chunks: chunk i of the
// output packs the uint64 balances 4 c .. 4 c + 3 of chunk c = idx[i] in
// SSZ little-endian order; a value whose flat index is >= n_vals (or a
// chunk past the end) is zero, so a pad lane's chunk is all-zero words.
// One thread per chunk.  Bound: bytes (8 + 32 read and 32 written per
// lane), a gather of 32-byte rows.
//
// K6 replaces incremental.py:196 _gather_proof_paths: for each index the
// leaf level0[min(idx, 2**depth - 1)] and, for each level l below the
// root, the sibling level_l[min((idx >> l) ^ 1, 2**(depth - l) - 1)],
// bottom-up.  One thread per (index, row) copies 32 bytes.  Bound: bytes.
#include <cuda_runtime.h>

#include <cstdint>

#include "sha256.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLevels = 64;

// The level pointers of one forest, passed by value (kernel parameter
// space), level 0 first.
struct Levels {
  const uint4* p[kMaxLevels];
};

unsigned blocks_for(long long n) { return (unsigned)((n + kThreads - 1) / kThreads); }

__device__ __forceinline__ long long lane() {
  return blockIdx.x * (long long)blockDim.x + threadIdx.x;
}

__global__ void leaf_scatter_kernel(const long long* __restrict__ idx,
                                    const uint4* __restrict__ words,
                                    uint4* __restrict__ level0, long long m,
                                    unsigned long long capacity) {
  long long i = lane();
  if (i >= m) return;
  unsigned long long r = (unsigned long long)idx[i];
  if (r >= capacity) return;
  level0[2 * r] = words[2 * i];
  level0[2 * r + 1] = words[2 * i + 1];
}

__global__ void update_level_kernel(const long long* __restrict__ idx,
                                    const uint4* __restrict__ child,
                                    uint4* __restrict__ parent, long long m,
                                    int shift, unsigned long long size) {
  long long i = lane();
  if (i >= m) return;
  unsigned long long p = (unsigned long long)idx[i] >> shift;
  if (p >= size) return;
  uint32_t w[16], d[8];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    uint4 v = child[4 * p + q];
    w[4 * q] = v.x; w[4 * q + 1] = v.y; w[4 * q + 2] = v.z; w[4 * q + 3] = v.w;
  }
  cst::sha256_64B(w, d);
  parent[2 * p] = make_uint4(d[0], d[1], d[2], d[3]);
  parent[2 * p + 1] = make_uint4(d[4], d[5], d[6], d[7]);
}

__global__ void balance_chunks_kernel(const unsigned long long* __restrict__ vals,
                                      const long long* __restrict__ idx,
                                      uint4* __restrict__ out, long long m,
                                      unsigned long long n_vals) {
  long long i = lane();
  if (i >= m) return;
  unsigned long long c = (unsigned long long)idx[i];
  uint32_t w[8];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    // c <= n_vals / 4 keeps 4 c + k from wrapping
    unsigned long long f = 4 * c + k;
    unsigned long long v = (c <= n_vals / 4 && f < n_vals) ? vals[f] : 0ull;
    w[2 * k] = cst::bswap32((uint32_t)v);
    w[2 * k + 1] = cst::bswap32((uint32_t)(v >> 32));
  }
  out[2 * i] = make_uint4(w[0], w[1], w[2], w[3]);
  out[2 * i + 1] = make_uint4(w[4], w[5], w[6], w[7]);
}

__global__ void proof_paths_kernel(Levels levels, const long long* __restrict__ idx,
                                   uint4* __restrict__ leaves, uint4* __restrict__ paths,
                                   long long m, int depth) {
  long long t = lane();
  if (t >= m * (depth + 1)) return;
  long long i = t / (depth + 1);
  int row = (int)(t % (depth + 1));
  unsigned long long x = (unsigned long long)idx[i];
  if (row == 0) {
    unsigned long long cap = 1ull << depth;
    unsigned long long r = x < cap ? x : cap - 1;
    leaves[2 * i] = levels.p[0][2 * r];
    leaves[2 * i + 1] = levels.p[0][2 * r + 1];
    return;
  }
  int l = row - 1;
  unsigned long long size = 1ull << (depth - l);
  unsigned long long s = (x >> l) ^ 1ull;
  if (s > size - 1) s = size - 1;
  long long o = 2 * (i * depth + l);
  paths[o] = levels.p[l][2 * s];
  paths[o + 1] = levels.p[l][2 * s + 1];
}

}  // namespace

extern "C" int leaf_scatter_launch(const void* idx, const void* words, void* level0,
                                   long long m, long long capacity, void* stream) {
  leaf_scatter_kernel<<<blocks_for(m), kThreads, 0, (cudaStream_t)stream>>>(
      (const long long*)idx, (const uint4*)words, (uint4*)level0, m,
      (unsigned long long)capacity);
  return (int)cudaGetLastError();
}

extern "C" int update_level_launch(const void* idx, const void* child, void* parent,
                                   long long m, int shift, long long size, void* stream) {
  update_level_kernel<<<blocks_for(m), kThreads, 0, (cudaStream_t)stream>>>(
      (const long long*)idx, (const uint4*)child, (uint4*)parent, m, shift,
      (unsigned long long)size);
  return (int)cudaGetLastError();
}

extern "C" int balance_chunks_launch(const void* vals, const void* idx, void* out,
                                     long long m, long long n_vals, void* stream) {
  balance_chunks_kernel<<<blocks_for(m), kThreads, 0, (cudaStream_t)stream>>>(
      (const unsigned long long*)vals, (const long long*)idx, (uint4*)out, m,
      (unsigned long long)n_vals);
  return (int)cudaGetLastError();
}

// level_ptrs: depth + 1 device pointers (a host array), level 0 first.
extern "C" int proof_paths_launch(const void* const* level_ptrs, int depth,
                                  const void* idx, void* leaves, void* paths,
                                  long long m, void* stream) {
  if (depth < 0 || depth >= kMaxLevels) return (int)cudaErrorInvalidValue;
  Levels levels = {};
  for (int l = 0; l <= depth; ++l) levels.p[l] = (const uint4*)level_ptrs[l];
  long long n = m * (depth + 1);
  proof_paths_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      levels, (const long long*)idx, (uint4*)leaves, (uint4*)paths, m, depth);
  return (int)cudaGetLastError();
}
