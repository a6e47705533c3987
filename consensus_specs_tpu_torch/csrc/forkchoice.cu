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
// the rung, with __syncthreads() between phases and double buffers in a
// global scratch (subtree sums s, the viability bits v, the ancestor
// pointers p, the best-child pointers bc).  The subtree sums and the
// viability doubling share their pointer sequence, so they run in the
// same rounds.  Bound: bytes, about 110 a block read; the time is the
// latency of about 4 * log2(rung) + 30 barrier phases.
#include <cuda_runtime.h>

#include <cstdint>

#ifndef FC_HEAD_THREADS
#define FC_HEAD_THREADS 1024
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

// The scratch of one rung of n = nb_pad + 1 slots, 8-byte arrays first.
struct HeadScratch {
  long long *s0, *s1, *mx;
  int *p0, *p1, *v0, *v1, *has_child, *bc0, *bc1;
  unsigned char* cand;
};

__device__ HeadScratch head_scratch(void* base, int n) {
  HeadScratch h;
  long long* q = (long long*)base;
  h.s0 = q;
  h.s1 = q + n;
  h.mx = q + 2 * (long long)n;
  int* r = (int*)(q + 3 * (long long)n);
  h.p0 = r;
  h.p1 = r + n;
  h.v0 = r + 2 * (long long)n;
  h.v1 = r + 3 * (long long)n;
  h.has_child = r + 4 * (long long)n;
  h.bc0 = r + 5 * (long long)n;
  h.bc1 = r + 6 * (long long)n;
  h.cand = (unsigned char*)(r + 7 * (long long)n);
  return h;
}

long long head_scratch_bytes(int n) { return (long long)n * (3 * 8 + 7 * 4 + 1); }

#define FOR_EACH(i, n) for (int i = threadIdx.x; i < (n); i += blockDim.x)

__global__ void __launch_bounds__(FC_HEAD_THREADS)
fc_head_kernel(const int* __restrict__ parent, const long long* __restrict__ weight,
               int boost_idx, long long boost_amt, const bool* __restrict__ real,
               const long long* __restrict__ block_epoch,
               const long long* __restrict__ je, const long long* __restrict__ uje,
               const bool* __restrict__ fin_ok, const long long* __restrict__ limbs,
               long long sj, long long sf, long long cur, int justified_idx,
               int nb_pad, int rounds, void* scratch, int* __restrict__ out) {
  const int n = nb_pad + 1;
  HeadScratch h = head_scratch(scratch, n);
  long long *s = h.s0, *s_nxt = h.s1;
  int *p = h.p0, *p_nxt = h.p1, *v = h.v0, *v_nxt = h.v1;

  // the boosted weights of the live rows; the ancestor pointers
  FOR_EACH(i, n) {
    long long w = weight[i] + (i == boost_idx ? boost_amt : 0);
    s[i] = real[i] ? w : 0;
    p[i] = parent[i];
    h.has_child[i] = 0;
  }
  __syncthreads();
  FOR_EACH(i, n) {
    if (real[i]) h.has_child[parent[i]] = 1;
  }
  __syncthreads();
  // leaf viability: the voting source and the finalized descent, on
  // leaves only
  FOR_EACH(i, n) {
    long long vs = block_epoch[i] < cur ? uje[i] : je[i];
    bool vs_ok = sj == 0 || vs == sj || vs + 2 >= cur;
    bool f_ok = sf == 0 || fin_ok[i];
    v[i] = (vs_ok && f_ok && real[i] && h.has_child[i] == 0) ? 1 : 0;
  }
  __syncthreads();

  // subtree sums s += scatter(s -> p) and subtree-OR of the viable
  // leaves, p = p[p]: each round reads s, v and p, writes the other
  // buffers.  Additions into the dummy slot are skipped, so it stays 0.
  for (int r = 0; r < rounds; ++r) {
    FOR_EACH(i, n) {
      s_nxt[i] = s[i];
      v_nxt[i] = v[i];
      p_nxt[i] = p[p[i]];
    }
    __syncthreads();
    FOR_EACH(i, n) {
      int t = p[i];
      if (t != nb_pad) {
        if (s[i] != 0) add_i64(&s_nxt[t], s[i]);
        if (v[i] != 0) v_nxt[t] = 1;
      }
    }
    __syncthreads();
    long long* ts = s; s = s_nxt; s_nxt = ts;
    int* tp = p; p = p_nxt; p_nxt = tp;
    int* tv = v; v = v_nxt; v_nxt = tv;
  }

  // the best child of each parent: a masked argmax over the subtree sum,
  // then over each of the 8 root words (zero-extended, big-endian)
  FOR_EACH(i, n) {
    h.cand[i] = real[i] && v[i] > 0 && parent[i] < nb_pad;
  }
  for (int k = 0; k < 9; ++k) {
    FOR_EACH(i, n) h.mx[i] = -1;
    __syncthreads();
    FOR_EACH(i, n) {
      if (h.cand[i]) atomicMax(&h.mx[parent[i]], k == 0 ? s[i] : limbs[8LL * i + k - 1]);
    }
    __syncthreads();
    FOR_EACH(i, n) {
      if (h.cand[i]) {
        long long key = k == 0 ? s[i] : limbs[8LL * i + k - 1];
        h.cand[i] = key == h.mx[parent[i]];
      }
    }
    __syncthreads();
  }

  // best_child (a node without a viable child points at itself), then
  // the head as the fixpoint of doubling from the justified block
  int *bc = h.bc0, *bc_nxt = h.bc1;
  FOR_EACH(i, n) bc[i] = i;
  __syncthreads();
  FOR_EACH(i, n) {
    if (h.cand[i]) bc[parent[i]] = i;
  }
  __syncthreads();
  for (int r = 0; r < rounds; ++r) {
    FOR_EACH(i, n) bc_nxt[i] = bc[bc[i]];
    __syncthreads();
    int* t = bc; bc = bc_nxt; bc_nxt = t;
  }
  if (threadIdx.x == 0) *out = bc[justified_idx];
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

extern "C" long long fc_head_scratch_bytes(int n) { return head_scratch_bytes(n); }

extern "C" int fc_head_launch(const void* parent, const void* weight, int boost_idx,
                              long long boost_amt, const void* real,
                              const void* block_epoch, const void* je, const void* uje,
                              const void* fin_ok, const void* limbs, long long sj,
                              long long sf, long long cur, int justified_idx,
                              int nb_pad, int rounds, void* scratch, void* out,
                              void* stream) {
  fc_head_kernel<<<1, FC_HEAD_THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)parent, (const long long*)weight, boost_idx, boost_amt,
      (const bool*)real, (const long long*)block_epoch, (const long long*)je,
      (const long long*)uje, (const bool*)fin_ok, (const long long*)limbs, sj, sf,
      cur, justified_idx, nb_pad, rounds, scratch, (int*)out);
  return (int)cudaGetLastError();
}
