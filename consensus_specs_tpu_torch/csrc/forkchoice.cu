// K21, K22 and K23: the proto-array fork-choice kernels
// (consensus_specs_tpu_torch/forkchoice/kernels.py, whose plain versions
// they are held against).  Every array carries one dummy slot (index ==
// its rung) that masked rows address in the reference; what lands there
// is unspecified and no live chain reads it, so these kernels skip the
// masked writes rather than collide on it.  All arithmetic is exact
// integer; int64 atomics add as unsigned two's complement.
//
// K21 fc_apply replaces consensus_specs_tpu/forkchoice/kernels.py:75
// _apply_kernel: a batch of B latest-message candidates folds into the
// latest-message table (lm_epoch, lm_block) and the block weights in
// place, in three launches on one stream:
//   1. best[val_idx[i]] = -1 for every row (only the entries the batch
//      reads are reset, not all V + 1);
//   2. atomicMax(best[val_idx[i]], epoch * B + (B - 1 - i)): the winner
//      key of each validator (highest epoch, then earliest row);
//   3. one thread per row: accept = winner && epoch >= 0 && epoch >
//      lm_epoch[v] && can_update[v]; an accepted row writes lm_epoch[v]
//      and lm_block[v] and moves its balance from the old vote block to
//      the new one with two atomic adds; every row writes its accept bit.
// Updating the table in place is safe: the keys are distinct (they hold
// the row), so at most one row per validator is the winner, and only an
// accepted winner writes its validator's slot, after reading the old
// values.  A losing row of the same validator may read the slot while it
// is written, but its accept is already false and nothing it read is
// used.  Bound on an H100: bytes, and what this batch touches (the batch
// rows, the table entries of its validators, the weights of its blocks),
// about 50 bytes a row; at B = 16384 the three launches' latency is the
// time.
//
// K22 fc_refresh replaces kernels.py:130 _refresh_kernel: out[b] = the sum
// of balance[v] over the validators with lm_block[v] == b.  One thread
// per validator, an int64 atomic add into NB + 1 slots after a memset.
// Bound: bytes (12 a validator read); at 2**20 validators over 1025
// slots the atomics on one slot serialise.
//
// K23 fc_head replaces kernels.py:148 _head_kernel: the LMD-GHOST head of
// one padded rung.  Each round of pointer jumping reads the whole array
// before any of it is written, so the phases need barriers across the
// rung: the kernel is one block of FC_HEAD_THREADS threads striding over
// the rung's NB live-or-padded slots (the dummy slot NB is constant and
// left out), its arrays (HeadArrays, kHeadSlotBytes a slot) in shared
// memory where they fit (NB <= 4096 on an H100) and in a global scratch
// past that (the same code; 16384 and up: 672 KB, past one SM's shared
// memory).  Its phases:
//   1. the boosted weights, the pointers, the leaf predicate, the live
//      rows (the only reads of the inputs but the root words); 2. has_child;
//   3. rounds of pointer jumping, one phase each: each slot adds its
//      subtree sum into its pointer's deltas (the rounds' only atomics;
//      a slot's next sum is its own plus its deltas, taken a round
//      later), ORs its viability into its pointer's, and jumps; deltas
//      and pointers double-buffered, v triple-buffered; the rounds end
//      once every pointer is the dummy slot (later rounds add nothing);
//   4. the tie-break of each parent's viable children: the subtree sum
//      (plus one, so that JAX's -1 floor is the unsigned 0; a sum below
//      -1 never survives), then the 8 root words in four rounds of two,
//      packed big-endian into one unsigned 64-bit key (read for the
//      round's candidates only); two phases a round (max, then survive),
//      mx double-buffered; each survivor writes itself as its parent's
//      best child, and the rounds end once no parent has two survivors;
//   5. best-child doubling until every new pointer is a fixpoint.
// The early exits give the same output as JAX's fixed rounds.  Bound:
// bytes (about 110 a block read); the time is the launch and the latency
// of the dependent phases, 2 + log2(depth) + 2 a tie-break round +
// log2(chain) on a tree, 14-16 at NB = 1024 on the smoke's (an empty
// phase of the block: about 0.05 us on an H100, its launch about 5 us).
// The rounds' 64-bit shared atomics are the compiler's compare-and-swap
// loops (Hopper has no 64-bit shared atomic add or max); two 32-bit adds
// with the carry, or a CAS loop of our own, were slower.
#include <cuda_runtime.h>

#include <cstdint>

// K23's block, chosen by timing 256, 512 and 1024 at NB = 1024 (PERF.md)
#ifndef FC_HEAD_THREADS
#define FC_HEAD_THREADS 512
#endif

namespace {

constexpr int kThreads = 256;

unsigned blocks_for(long long n) { return (unsigned)((n + kThreads - 1) / kThreads); }

__device__ __forceinline__ long long lane() {
  return blockIdx.x * (long long)blockDim.x + threadIdx.x;
}

__device__ __forceinline__ void add_i64(long long* p, long long v) {
  atomicAdd((unsigned long long*)p, (unsigned long long)v);
}

// --- K21 -------------------------------------------------------------------

__global__ void fc_reset_best_kernel(const int* __restrict__ val_idx,
                                     long long* __restrict__ best, int b) {
  long long i = lane();
  if (i < b) best[val_idx[i]] = -1;
}

__global__ void fc_best_kernel(const int* __restrict__ val_idx,
                               const long long* __restrict__ att_epoch,
                               long long* __restrict__ best, int b) {
  long long i = lane();
  if (i >= b) return;
  long long key = att_epoch[i] * b + (b - 1 - i);
  atomicMax(&best[val_idx[i]], key);
}

__global__ void fc_accept_kernel(const int* __restrict__ val_idx,
                                 const long long* __restrict__ att_epoch,
                                 const int* __restrict__ att_block,
                                 long long* lm_epoch, int* lm_block,
                                 const long long* __restrict__ balance,
                                 const bool* __restrict__ can_update,
                                 long long* node_weight,
                                 const long long* __restrict__ best,
                                 bool* __restrict__ accept, int b, int nb_pad) {
  long long i = lane();
  if (i >= b) return;
  int v = val_idx[i];
  long long ep = att_epoch[i];
  bool ok = best[v] == ep * b + (b - 1 - i) && ep >= 0;
  // only the winner row of v gets past here; it reads v's slot before it
  // writes it
  ok = ok && ep > lm_epoch[v] && can_update[v];
  accept[i] = ok;
  if (i == 0) node_weight[nb_pad] = 0;
  if (!ok) return;
  int old_block = lm_block[v];
  int new_block = att_block[i];
  long long bal = balance[v];
  lm_epoch[v] = ep;
  lm_block[v] = new_block;
  if (bal != 0) {
    if (old_block >= 0) add_i64(&node_weight[old_block], -bal);
    add_i64(&node_weight[new_block], bal);
  }
}

// --- K22 -------------------------------------------------------------------

__global__ void fc_refresh_kernel(const int* __restrict__ lm_block,
                                  const long long* __restrict__ balance,
                                  long long n, long long* __restrict__ out) {
  long long i = lane();
  if (i >= n) return;
  int blk = lm_block[i];
  long long bal = balance[i];
  if (blk >= 0 && bal != 0) add_i64(&out[blk], bal);
}

// --- K23 -------------------------------------------------------------------

// The arrays of one rung of n slots, 8-byte ones first: the subtree sums
// (each slot's own, later the tie-break's keys) and the two buffers of
// the deltas they take from their descendants (later the tie-break's two
// mx buffers), the pointers' two (later the survivor counts and the first
// best-child buffer; the second is mx's), the parents, the viability's
// three, the candidates (first has_child) and the live rows.
constexpr int kHeadSlotBytes = 3 * 8 + 3 * 4 + 3 + 1 + 1;
constexpr int kMaxShared = 232448;
constexpr int kMaxDevices = 64;

struct HeadArrays {
  long long* sum;
  long long* d[2];
  int* p[2];
  int* par;
  unsigned char* v[3];
  unsigned char* cand;
  unsigned char* live;
};

__device__ __forceinline__ HeadArrays head_arrays(unsigned char* base, int n) {
  HeadArrays h;
  long long* q = (long long*)base;
  h.sum = q;
  h.d[0] = q + n;
  h.d[1] = q + 2LL * n;
  int* r = (int*)(q + 3LL * n);
  h.p[0] = r;
  h.p[1] = r + n;
  h.par = r + 2LL * n;
  unsigned char* c = (unsigned char*)(r + 3LL * n);
  for (int k = 0; k < 3; ++k) h.v[k] = c + (long long)k * n;
  h.cand = c + 3LL * n;
  h.live = c + 4LL * n;
  return h;
}

long long head_bytes(int n) { return (long long)n * kHeadSlotBytes; }

// the root words 2k - 2 and 2k - 1 of block i, big-endian, as one key
__device__ __forceinline__ unsigned long long word_pair(const long long* limbs,
                                                        int i, int k) {
  const long long* w = limbs + 8LL * i + 2 * k - 2;
  return ((unsigned long long)(unsigned)w[0] << 32) | (unsigned)w[1];
}

#define FOR_EACH(i, n) for (int i = threadIdx.x; i < (n); i += blockDim.x)

template <bool kShared>
__global__ void __launch_bounds__(FC_HEAD_THREADS)
fc_head_kernel(const int* __restrict__ parent, const long long* __restrict__ weight,
               int boost_idx, long long boost_amt, const bool* __restrict__ real,
               const long long* __restrict__ block_epoch,
               const long long* __restrict__ je, const long long* __restrict__ uje,
               const bool* __restrict__ fin_ok, const long long* __restrict__ limbs,
               long long sj, long long sf, long long cur, int justified_idx,
               int nb_pad, int rounds, unsigned char* scratch, int* __restrict__ out,
               int* __restrict__ stats) {
  extern __shared__ __align__(16) unsigned char fc_smem[];
  const int n = nb_pad + 1;
  const HeadArrays h = head_arrays(kShared ? fc_smem : scratch, n);

  // The dummy slot (index nb_pad) is a padded row, its own parent and not
  // live: its sum and viability stay 0 (nothing adds into it) and its
  // pointers nb_pad, so the phases leave it out and thread 0 writes it
  // once.
  if (threadIdx.x == 0) {
    h.sum[nb_pad] = h.d[0][nb_pad] = h.d[1][nb_pad] = 0;
    for (int k = 0; k < 3; ++k) h.v[k][nb_pad] = 0;
    h.p[0][nb_pad] = h.p[1][nb_pad] = h.par[nb_pad] = nb_pad;
    h.cand[nb_pad] = h.live[nb_pad] = 0;
  }

  // 1. the boosted weights of the live rows, the pointers, the leaf
  // predicate but has_child; the first round's targets zeroed
  FOR_EACH(i, nb_pad) {
    // every load first and unconditional, so that they overlap
    const int pi = parent[i];
    const unsigned long long wi = (unsigned long long)weight[i];
    const long long be = block_epoch[i], u = uje[i], j = je[i];
    const bool fin = fin_ok[i], live = real[i];
    const long long w = (long long)(wi + (i == boost_idx ? (unsigned long long)boost_amt : 0));
    const long long vs = be < cur ? u : j;
    const bool vs_ok = sj == 0 || vs == sj || vs + 2 >= cur;
    h.sum[i] = live ? w : 0;
    h.d[0][i] = h.d[1][i] = 0;
    h.p[0][i] = pi;
    h.par[i] = pi;
    h.v[0][i] = vs_ok && (sf == 0 || fin) && live;
    h.v[1][i] = 0;
    h.cand[i] = 0;
    h.live[i] = live;
  }
  __syncthreads();
  // 2. has_child (racing writers all store 1)
  FOR_EACH(i, nb_pad) {
    if (h.live[i]) h.cand[h.par[i]] = 1;
  }
  __syncthreads();

  // 3. s_(r+1) = s_r + scatter(s_r -> p_r), v likewise with OR, p_(r+1) =
  // p_r[p_r].  Only the scatter is atomic: round r adds s_r into the
  // deltas d_r at the pointers (never the dummy slot), and each slot
  // takes s_(r+1) = s_r + d_r as its own, one round later.
  int r = 0;
  for (;;) {
    long long* d = h.d[r % 2];
    long long* d_last = h.d[(r + 1) % 2];
    unsigned char* v = h.v[r % 3];
    unsigned char* v_nxt = h.v[(r + 1) % 3];
    const int* p = h.p[r % 2];
    int more = 0;
    FOR_EACH(i, nb_pad) {
      const long long si = (long long)((unsigned long long)h.sum[i] +
                                       (unsigned long long)d_last[i]);
      h.sum[i] = si;
      d_last[i] = 0;                      // the next round's deltas
      const bool vi = r == 0 ? v[i] && !h.cand[i] : v[i] != 0;
      const int t = p[i];
      if (vi) v_nxt[i] = 1;
      if (t != nb_pad) {
        if (si != 0) atomicAdd((unsigned long long*)&d[t], (unsigned long long)si);
        if (vi) v_nxt[t] = 1;
      }
      const int tt = p[t];
      h.p[(r + 1) % 2][i] = tt;
      more |= tt != nb_pad;
      h.v[(r + 2) % 3][i] = 0;
    }
    ++r;
    if (!__syncthreads_or(more) || r == rounds) break;
  }
  const unsigned char* v = h.v[r % 3];

  // 4. the tie-break: round 0 on the subtree sum, rounds 1-4 on the word
  // pairs, each round's key kept in sum (own slots only) for its second
  // phase; mx[0] is the delta buffer the last sum round zeroed, mx[1] its
  // deltas, zeroed once read
  unsigned long long* mx[2] = {(unsigned long long*)h.d[r % 2],
                               (unsigned long long*)h.d[(r + 1) % 2]};
  unsigned long long* key = (unsigned long long*)h.sum;
  int* cnt = h.p[r % 2];
  int* bc = h.p[(r + 1) % 2];
  FOR_EACH(i, nb_pad) {
    const unsigned long long su = (unsigned long long)h.sum[i] + mx[1][i];
    const long long si = (long long)su;
    const bool c = h.live[i] && v[i] && h.par[i] < nb_pad && si >= -1;
    h.cand[i] = c;
    key[i] = su + 1;
    if (c) atomicMax(&mx[0][h.par[i]], su + 1);
    mx[1][i] = 0;
    cnt[i] = 0;
    bc[i] = i;
  }
  __syncthreads();
  int k = 0;
  for (;;) {
    int tie = 0;
    FOR_EACH(i, nb_pad) {
      if (!h.cand[i]) continue;
      const int pi = h.par[i];
      if (key[i] != mx[k % 2][pi]) {
        h.cand[i] = 0;
        continue;
      }
      tie |= atomicAdd(&cnt[pi], 1) != 0;
      bc[pi] = i;
    }
    if (!__syncthreads_or(tie) || k == 4) break;
    ++k;
    FOR_EACH(i, nb_pad) {
      if (h.cand[i]) {
        key[i] = word_pair(limbs, i, k);
        atomicMax(&mx[k % 2][h.par[i]], key[i]);
      }
      mx[(k + 1) % 2][i] = 0;
      cnt[i] = 0;
    }
    __syncthreads();
  }

  // 5. the head: the fixpoint of doubling on best_child from the
  // justified block; a round ends the doubling once every new pointer is
  // a fixpoint of the old ones (and so of the new)
  int* bc_nxt = (int*)mx[0];
  int q = 0;
  while (q < rounds) {
    int more = 0;
    FOR_EACH(i, nb_pad) {
      const int x = bc[bc[i]];
      bc_nxt[i] = x;
      more |= bc[x] != x;
    }
    int* t = bc; bc = bc_nxt; bc_nxt = t;
    ++q;
    if (!__syncthreads_or(more)) break;
  }
  if (threadIdx.x == 0) {
    *out = bc[justified_idx];
    if (stats) {                          // the rounds each step ran
      stats[0] = r;
      stats[1] = k + 1;
      stats[2] = q;
    }
  }
}

// n empty barrier phases of K23's block: their time over n is the cost of
// one of K23's dependent phases before its work
__global__ void __launch_bounds__(FC_HEAD_THREADS)
fc_barrier_probe_kernel(int n, int* __restrict__ out) {
  int acc = 0;
  for (int i = 0; i < n; ++i) acc += __syncthreads_or(threadIdx.x == (unsigned)(i & 31));
  if (threadIdx.x == 0) *out = acc;
}

// the shared-memory route's opt-in, once a device and size
int head_allowed[kMaxDevices];

int head_allow_shared(size_t shm) {
  int dev = 0;
  int err = cudaGetDevice(&dev);
  if (err) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (head_allowed[dev] >= (int)shm) return 0;
  err = cudaFuncSetAttribute(fc_head_kernel<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shm);
  if (!err) head_allowed[dev] = (int)shm;
  return err;
}

}  // namespace

extern "C" int fc_apply_launch(const void* val_idx, const void* att_epoch,
                               const void* att_block, void* lm_epoch, void* lm_block,
                               const void* balance, const void* can_update,
                               void* node_weight, void* best, void* accept, int b,
                               int nb_pad, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  fc_reset_best_kernel<<<blocks_for(b), kThreads, 0, st>>>((const int*)val_idx,
                                                          (long long*)best, b);
  fc_best_kernel<<<blocks_for(b), kThreads, 0, st>>>(
      (const int*)val_idx, (const long long*)att_epoch, (long long*)best, b);
  fc_accept_kernel<<<blocks_for(b), kThreads, 0, st>>>(
      (const int*)val_idx, (const long long*)att_epoch, (const int*)att_block,
      (long long*)lm_epoch, (int*)lm_block, (const long long*)balance,
      (const bool*)can_update, (long long*)node_weight, (const long long*)best,
      (bool*)accept, b, nb_pad);
  return (int)cudaGetLastError();
}

extern "C" int fc_refresh_launch(const void* lm_block, const void* balance, long long n,
                                 int nb_pad, void* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(out, 0, (size_t)(nb_pad + 1) * sizeof(long long), st);
  if (err != cudaSuccess) return (int)err;
  fc_refresh_kernel<<<blocks_for(n), kThreads, 0, st>>>(
      (const int*)lm_block, (const long long*)balance, n, (long long*)out);
  return (int)cudaGetLastError();
}

// the global scratch of the large-rung route; 0 where the rung fits
// shared memory
extern "C" long long fc_head_scratch_bytes(int n) {
  return head_bytes(n) <= kMaxShared ? 0 : head_bytes(n);
}

extern "C" int fc_head_launch(const void* parent, const void* weight, int boost_idx,
                              long long boost_amt, const void* real,
                              const void* block_epoch, const void* je, const void* uje,
                              const void* fin_ok, const void* limbs, long long sj,
                              long long sf, long long cur, int justified_idx,
                              int nb_pad, int rounds, void* scratch, void* out,
                              void* stats, void* stream) {
  const long long shm = head_bytes(nb_pad + 1);
  const bool shared = shm <= kMaxShared;
  if (shared) {
    const int err = head_allow_shared((size_t)shm);
    if (err) return err;
  } else if (scratch == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  auto kernel = shared ? fc_head_kernel<true> : fc_head_kernel<false>;
  kernel<<<1, FC_HEAD_THREADS, shared ? (size_t)shm : 0, (cudaStream_t)stream>>>(
      (const int*)parent, (const long long*)weight, boost_idx, boost_amt,
      (const bool*)real, (const long long*)block_epoch, (const long long*)je,
      (const long long*)uje, (const bool*)fin_ok, (const long long*)limbs, sj, sf,
      cur, justified_idx, nb_pad, rounds, (unsigned char*)scratch, (int*)out,
      (int*)stats);
  return (int)cudaGetLastError();
}

extern "C" int fc_barrier_probe_launch(int n, void* out, void* stream) {
  fc_barrier_probe_kernel<<<1, FC_HEAD_THREADS, 0, (cudaStream_t)stream>>>(n, (int*)out);
  return (int)cudaGetLastError();
}
