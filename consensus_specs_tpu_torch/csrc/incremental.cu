// K4, K5 and K6: the kernels of the incremental Merkle forest
// (consensus_specs_tpu_torch/parallel/incremental.py).
//
// A forest keeps every level of one SSZ list's data tree: level 0 holds
// the 2**depth leaf chunks, level k the 2**(depth-k) nodes above them,
// each node 8 big-endian uint32 words (two uint4).  Indices are int64 and
// are read as unsigned, so a negative index is out of range like any
// index >= the level's size.
//
// K4 replaces all of consensus_specs_tpu/parallel/incremental.py:122
// _update_dirty_impl: a forest's whole dirty-path update, for one or two
// forests at once, in one cooperative launch.  Each level keeps JAX's
// regime, picked from the rung M (the padded dirty count): a sparse level
// (wider than M) hashes the pair under parent = idx[i] >> level for each
// lane i, dropping a parent past the level (of a run of consecutive lanes
// with one parent only the first hashes: lanes with one parent write the
// same 32 bytes, the benign race JAX's scatter relies on); a dense level
// (no wider than M) re-hashes every node, so upper levels loaded stale
// through from_layers come out as JAX's.  Duplicate indices carry equal
// words.  The launch runs, with a grid barrier after each:
//   0. the leaf scatter (level0[idx[i]] = words[i], dropping idx[i] >=
//      2**depth, the sentinel of a padded dirty set) over the whole grid,
//      and a check that each forest's indices are sorted;
//   A. the sparse levels.  Sorted indices: each block takes a contiguous
//      range of a forest's lanes, cut where the parent at the top sparse
//      level changes, so every parent's dirty children lie in one block,
//      and climbs all sparse levels under __syncthreads.  Otherwise (any
//      order is allowed) one grid-wide walk and one barrier a level;
//   B. the dense levels in chunks: a block re-hashes up to 256 nodes of a
//      level and carries them up to their one root, the levels between
//      in shared memory; as many such phases as the roots need;
//   C. the last levels, in block 0 alone.
// The plan (the phases, the grid, the blocks of each forest) is the
// wrapper's (parallel/incremental.py forest_plan).  The grid is at most
// the blocks the occupancy API finds co-resident; a launch that cannot be
// co-resident fails.  Level data that the launch writes is read through L2
// (__ldcg).
// Bound on an H100: integer issue (about 2,300 32-bit integer instructions
// a message) and, below it, the levels' dependent chain: one 64-byte
// SHA-256 message takes one thread about 2.4 us (about 2,400 instructions
// at half an instruction a cycle), and every level waits on the one below.

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
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "sha256.cuh"

namespace cg = cooperative_groups;

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

// --- K4 ---------------------------------------------------------------------

constexpr int kForestThreads = 256;
constexpr int kMaxForests = 2;
constexpr int kMaxPhases = 8;

struct ForestArg {
  uint4* level[kMaxLevels];
  const long long* idx;
  const uint4* words;
  long long rung;
  int depth;
  int sparse;               // levels 1 .. sparse are sparse
  int group0, groups;       // phase A's blocks: group0 .. group0 + groups - 1
  int phase_s[kMaxPhases];  // phase j's chunks start at level phase_s[j] (0: none)
  int phase_k[kMaxPhases];  // ... and hold 2**phase_k[j] nodes there
  int tail_s;               // levels tail_s .. depth in block 0 (> depth: none)
};

struct ForestArgs {
  ForestArg f[kMaxForests];
  int n_forests, n_phases;
};

// One node: parent level[lvl][p] = H(children), the children's 16 words
// either from level lvl - 1 (through L2) or from `from` (shared memory),
// the digest also to `to` (shared memory) where given.  Every phase calls
// this one copy of the hash.
__device__ __noinline__ void hash_node(const uint4* child, uint4* parent,
                                          unsigned long long p, const uint4* from, uint4* to) {
  uint32_t w[16], d[8];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    uint4 v = from ? from[q] : __ldcg(child + 4 * p + q);
    w[4 * q] = v.x; w[4 * q + 1] = v.y; w[4 * q + 2] = v.z; w[4 * q + 3] = v.w;
  }
  cst::sha256_64B(w, d);
  uint4 lo = make_uint4(d[0], d[1], d[2], d[3]), hi = make_uint4(d[4], d[5], d[6], d[7]);
  parent[2 * p] = lo;
  parent[2 * p + 1] = hi;
  if (to) {
    to[0] = lo;
    to[1] = hi;
  }
}

__device__ __forceinline__ unsigned long long uidx(const ForestArg& f, long long i) {
  return (unsigned long long)__ldg(f.idx + i);
}

// Sparse level lvl, lane i: hash the parent unless it is past the level
// or an earlier lane of its run hashes it.
__device__ __forceinline__ void sparse_lane(const ForestArg& f, int lvl, long long i) {
  unsigned long long size = 1ull << (f.depth - lvl), p = uidx(f, i) >> lvl;
  if (p >= size || (i > 0 && (uidx(f, i - 1) >> lvl) == p)) return;
  hash_node(f.level[lvl - 1], f.level[lvl], p, nullptr, nullptr);
}

// The lanes [lo, hi) of forest f in this block: block q of its group
// takes the nominal range q * per .. (q + 1) * per, both ends moved up to
// where the parent at the top sparse level changes, or to a lane past the
// forest (it hashes at no level: the sentinels of a padded set).
__device__ __forceinline__ long long run_start(const ForestArg& f, long long j) {
  int top = f.sparse;
  for (;; j += 32) {
    long long x = j + (threadIdx.x & 31);
    bool cut = x <= 0 || x >= f.rung || (uidx(f, x) >> f.depth) != 0 ||
               (uidx(f, x - 1) >> top) != (uidx(f, x) >> top);
    unsigned m = __ballot_sync(0xffffffffu, cut);
    if (m) return j + __ffs(m) - 1;
  }
}

// Phase A with sorted indices: this block's range of each forest whose
// group holds it, all sparse levels under __syncthreads.
__device__ void sparse_in_block(const ForestArgs& a) {
  __shared__ long long range[2];
  for (int k = 0; k < a.n_forests; ++k) {
    const ForestArg& f = a.f[k];
    int q = (int)blockIdx.x - f.group0;
    if (f.sparse == 0 || q < 0 || q >= f.groups) continue;
    long long per = (f.rung + f.groups - 1) / f.groups;
    if (threadIdx.x < 32) {
      long long lo = q * per < f.rung ? run_start(f, q * per) : f.rung;
      long long hi = (q + 1) * per < f.rung ? run_start(f, (q + 1) * per) : f.rung;
      if (threadIdx.x == 0) {
        range[0] = lo;
        range[1] = hi;
      }
    }
    __syncthreads();
    long long lo = range[0], hi = range[1];
    for (int lvl = 1; lvl <= f.sparse; ++lvl) {
      for (long long i = lo + threadIdx.x; i < hi; i += blockDim.x) sparse_lane(f, lvl, i);
      __syncthreads();
    }
  }
}

// A chunk: 2**k nodes of level s of forest f, from node c << k, carried
// up to their root at level s + k.
struct Chunk {
  int f, s, k;
  long long c;
};

// Up to two chunks on this block's threads (chunk i on the threads after
// chunk i - 1's), one level after another; a level's digests go to
// global memory and, for the next level, to shared memory (two buffers).
__device__ void run_chunks(const ForestArgs& a, const Chunk* ch, int n) {
  __shared__ uint4 buf[2][kForestThreads][2];
  int t = threadIdx.x, me = -1, base = 0, kmax = 0;
  for (int i = 0; i < n; ++i) {
    if (me < 0 && t < base + (1 << ch[i].k)) me = i;
    if (me < 0) base += 1 << ch[i].k;
    kmax = ch[i].k > kmax ? ch[i].k : kmax;
  }
  long long off = t - base;
  for (int l = 0; l <= kmax; ++l) {
    if (me >= 0 && l <= ch[me].k && off < (1LL << (ch[me].k - l))) {
      const ForestArg& f = a.f[ch[me].f];
      int lvl = ch[me].s + l;
      unsigned long long p = ((unsigned long long)ch[me].c << (ch[me].k - l)) + off;
      const uint4* from = l ? &buf[(l - 1) & 1][base + 2 * off][0] : nullptr;
      hash_node(f.level[lvl - 1], f.level[lvl], p, from, &buf[l & 1][t][0]);
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kForestThreads)
    forest_update_kernel(ForestArgs a, int* unsorted) {
  cg::grid_group grid = cg::this_grid();
  long long G = gridDim.x, b = blockIdx.x, T = blockDim.x;
  // 0. the leaf scatter over the grid, and the order check
  long long n0 = a.f[0].rung, total = n0 + (a.n_forests > 1 ? a.f[1].rung : 0);
  bool bad = false;
  for (long long w = b + G * threadIdx.x; w < total; w += G * T) {
    int k = w < n0 ? 0 : 1;
    const ForestArg& f = a.f[k];
    long long i = w - (k ? n0 : 0);
    unsigned long long r = uidx(f, i);
    if (i > 0 && uidx(f, i - 1) > r) bad = true;
    if (!(r >> f.depth)) {
      f.level[0][2 * r] = __ldg(f.words + 2 * i);
      f.level[0][2 * r + 1] = __ldg(f.words + 2 * i + 1);
    }
  }
  bad = __syncthreads_or(bad);
  if (threadIdx.x == 0) unsorted[b] = bad;
  grid.sync();
  bad = false;
  for (long long j = threadIdx.x; j < G; j += T) bad |= __ldcg(unsorted + j) != 0;
  bad = __syncthreads_or(bad);
  // A. the sparse levels
  int max_sparse = 0;
  for (int k = 0; k < a.n_forests; ++k)
    max_sparse = a.f[k].sparse > max_sparse ? a.f[k].sparse : max_sparse;
  if (!bad) {
    sparse_in_block(a);
  } else {
    for (int lvl = 1; lvl <= max_sparse; ++lvl) {
      long long m0 = lvl <= a.f[0].sparse ? n0 : 0;
      long long all = m0 + (a.n_forests > 1 && lvl <= a.f[1].sparse ? a.f[1].rung : 0);
      for (long long w = b + G * threadIdx.x; w < all; w += G * T) {
        int k = w < m0 ? 0 : 1;
        sparse_lane(a.f[k], lvl, w - (k ? m0 : 0));
      }
      if (lvl < max_sparse) grid.sync();
    }
  }
  // B. the dense levels in chunks, one phase after another
  for (int j = 0; j < a.n_phases; ++j) {
    grid.sync();
    long long c0 = 0, all = 0;
    for (int k = 0; k < a.n_forests; ++k) {
      const ForestArg& f = a.f[k];
      long long c = f.phase_s[j] ? 1LL << (f.depth - f.phase_s[j] - f.phase_k[j]) : 0;
      if (k == 0) c0 = c;
      all += c;
    }
    for (long long c = b; c < all; c += G) {
      Chunk ch;
      ch.f = c < c0 ? 0 : 1;
      ch.s = a.f[ch.f].phase_s[j];
      ch.k = a.f[ch.f].phase_k[j];
      ch.c = c - (ch.f ? c0 : 0);
      run_chunks(a, &ch, 1);
    }
  }
  // C. the last levels of every forest in block 0
  grid.sync();
  if (b != 0) return;
  Chunk ch[kMaxForests];
  int n = 0;
  for (int k = 0; k < a.n_forests; ++k) {
    const ForestArg& f = a.f[k];
    if (f.tail_s > f.depth) continue;
    ch[n].f = k;
    ch[n].s = f.tail_s;
    ch[n].k = f.depth - f.tail_s;
    ch[n].c = 0;
    ++n;
  }
  if (n) run_chunks(a, ch, n);
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

// K4's occupancy on the current device: its SMs and the blocks of
// kForestThreads that can be co-resident (the largest grid a launch may
// have).
extern "C" int forest_update_occupancy(int* sms, int* co_resident) {
  int dev = 0, per_sm = 0, coop = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess && !coop) err = cudaErrorNotSupported;
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, forest_update_kernel,
                                                        kForestThreads, 0);
  *co_resident = per_sm * *sms;
  return (int)err;
}

// K4 over n_forests (1 or 2) forests.  Forest k: depths[k] + 1 level
// pointers in level_ptrs (the forests' lists one after the other, level 0
// first), rungs[k] >= 1 padded dirty indices idx[k] and their leaf words
// words[k].  plan[k] is forest k's plan, ints: sparse, group0, groups,
// tail_s, then n_phases pairs (phase_s, phase_k) (forest_plan's).
// unsorted: grid ints of device scratch.
extern "C" int forest_update_launch(const void* const* level_ptrs, const int* depths,
                                    const void* const* idx, const void* const* words,
                                    const long long* rungs, const int* plan, int n_forests,
                                    int n_phases, int grid, void* unsorted, void* stream) {
  if (n_forests < 1 || n_forests > kMaxForests || n_phases < 0 || n_phases > kMaxPhases ||
      grid < 1)
    return (int)cudaErrorInvalidValue;
  ForestArgs a = {};
  a.n_forests = n_forests;
  a.n_phases = n_phases;
  int off = 0;
  for (int k = 0; k < n_forests; ++k) {
    int d = depths[k];
    if (d < 0 || d >= kMaxLevels || rungs[k] < 1) return (int)cudaErrorInvalidValue;
    ForestArg& f = a.f[k];
    for (int l = 0; l <= d; ++l) f.level[l] = (uint4*)level_ptrs[off + l];
    off += d + 1;
    f.idx = (const long long*)idx[k];
    f.words = (const uint4*)words[k];
    f.rung = rungs[k];
    f.depth = d;
    const int* p = plan + k * (4 + 2 * n_phases);
    f.sparse = p[0];
    f.group0 = p[1];
    f.groups = p[2];
    f.tail_s = p[3];
    for (int j = 0; j < n_phases; ++j) {
      f.phase_s[j] = p[4 + 2 * j];
      f.phase_k[j] = p[5 + 2 * j];
    }
  }
  void* args[] = {&a, &unsorted};
  cudaError_t err = cudaLaunchCooperativeKernel((const void*)forest_update_kernel, dim3(grid),
                                                dim3(kForestThreads), args, 0,
                                                (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
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
