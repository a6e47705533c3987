// K3: hash_tree_root of each Validator record.
//
// Replaces consensus_specs_tpu/parallel/merkle.py:157 validator_records_root
// and the pad-row masking of parallel/merkle.py:181 validator_registry_root
// (lines 193-199): rows with index >= length become zero chunks, not the
// record root of a zero Validator.
//
// A Validator has 8 field leaves: pubkey root, withdrawal credentials
// (both precomputed, (N, 8) big-endian words), then effective_balance,
// slashed, activation_eligibility_epoch, activation_epoch, exit_epoch and
// withdrawable_epoch, each a uint64 alone in its 32-byte chunk.  The record
// root is a depth-3 tree over them: 4 + 2 + 1 = 7 SHA-256 messages.
//
// Gather mode (an index array given) replaces bench.py:260
// dirty_record_roots: output row i is the record root of validator
// min(index[i], n_rows - 1), the fields read through the index in place
// of gathering seven arrays first; full mode (no index) hashes row i.
//
// Both run the tree level by level in a block of kRecords records, 4
// threads a record: level 0 on every thread (thread t hashes leaf pair
// t % 4 of record t / 4, the record's loads spread over its four
// threads), level 1 on the block's first half (thread t the node pair
// t % 2 of record t / 2), level 2 on its first quarter; the digests between
// levels in shared memory.  A warp with no message at a level does not
// issue, so the warp-instructions are the 7 messages' worth and the chain
// is 3 messages, where one thread a record ran a chain of 7 (at the
// incremental step's rung of 16384, 4 warps an SM).  The block is 16
// warps: a warp's scheduler on the H100 follows its index in the block
// (mod 4), so levels 1 and 2 (8 and 4 warps) still reach all four
// schedulers; a block of 4 warps left two of them idle at level 1 and
// three at level 2 (PERF.md).
//
// Bound on an H100: the ALU pipe, as K2 (sha256.cu): 7 messages of 2,084
// ALU instructions each (of 2,300) against 137 bytes read and written per
// validator.  The leaves are built in registers, so the 256-byte leaf
// level and the two interior levels never reach device memory.
#include <cuda_runtime.h>

#include <cstdint>

#include "sha256.cuh"

namespace {

// a block: kRecords records, 4 threads each
constexpr int kRecords = 128;
constexpr int kThreads = 4 * kRecords;
// words a digest takes in shared memory: 9, so that the 8 words of 32
// consecutive threads' digests fall in distinct banks
constexpr int kSlot = 9;

__device__ __forceinline__ void put_u64_leaf(uint32_t* w, unsigned long long v) {
  w[0] = cst::bswap32((uint32_t)v);
  w[1] = cst::bswap32((uint32_t)(v >> 32));
#pragma unroll
  for (int k = 2; k < 8; ++k) w[k] = 0;
}

__device__ __forceinline__ void hash_node_pair(const uint32_t* l, const uint32_t* r,
                                               uint32_t* out) {
  uint32_t w[16];
#pragma unroll
  for (int k = 0; k < 8; ++k) { w[k] = l[k]; w[8 + k] = r[k]; }
  cst::sha256_64B(w, out);
}

// The record tree of a block of kRecords rows (see the top).
__global__ void __launch_bounds__(kThreads) records_root_kernel(
    const uint4* __restrict__ pubkey_root, const uint4* __restrict__ credentials,
    const unsigned long long* __restrict__ effective_balance,
    const uint8_t* __restrict__ slashed,
    const unsigned long long* __restrict__ activation_eligibility_epoch,
    const unsigned long long* __restrict__ activation_epoch,
    const unsigned long long* __restrict__ exit_epoch,
    const unsigned long long* __restrict__ withdrawable_epoch,
    const long long* __restrict__ index, uint4* __restrict__ out, long long n,
    long long n_rows, long long length) {
  __shared__ uint32_t level0[kThreads * kSlot];
  __shared__ uint32_t level1[2 * kRecords * kSlot];
  const int t = threadIdx.x;
  const long long first = (long long)blockIdx.x * kRecords;
  const long long live = length < n ? length : n;
  // level 0: leaf pair k of record t / 4 (k = 0: pubkey root and
  // credentials; 1: effective balance and slashed; 2: the two activation
  // epochs; 3: exit and withdrawable)
  if (first + t / 4 < live) {
    long long r = first + t / 4;
    if (index != nullptr) {
      const unsigned long long x = (unsigned long long)index[r];
      r = x < (unsigned long long)n_rows ? (long long)x : n_rows - 1;
    }
    const int k = t & 3;
    uint32_t w[16];
    if (k == 0) {
      const uint4 a = pubkey_root[2 * r], b = pubkey_root[2 * r + 1];
      const uint4 c = credentials[2 * r], d = credentials[2 * r + 1];
      w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
      w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
      w[8] = c.x; w[9] = c.y; w[10] = c.z; w[11] = c.w;
      w[12] = d.x; w[13] = d.y; w[14] = d.z; w[15] = d.w;
    } else {
      unsigned long long x, y;
      if (k == 1) {
        x = effective_balance[r];
        y = slashed[r] ? 1ull : 0ull;
      } else if (k == 2) {
        x = activation_eligibility_epoch[r];
        y = activation_epoch[r];
      } else {
        x = exit_epoch[r];
        y = withdrawable_epoch[r];
      }
      put_u64_leaf(w, x);
      put_u64_leaf(w + 8, y);
    }
    uint32_t h[8];
    cst::sha256_64B(w, h);
#pragma unroll
    for (int j = 0; j < 8; ++j) level0[t * kSlot + j] = h[j];
  }
  __syncthreads();
  // level 1: node pair t % 2 of record t / 2, from level-0 slots 2t, 2t + 1
  if (t < 2 * kRecords && first + t / 2 < live) {
    uint32_t h[8];
    hash_node_pair(level0 + 2 * t * kSlot, level0 + (2 * t + 1) * kSlot, h);
#pragma unroll
    for (int j = 0; j < 8; ++j) level1[t * kSlot + j] = h[j];
  }
  __syncthreads();
  // level 2: record t's root, or zero chunks for a pad row
  const long long i = first + t;
  if (t < kRecords && i < n) {
    uint32_t root[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    if (i < live) hash_node_pair(level1 + 2 * t * kSlot, level1 + (2 * t + 1) * kSlot, root);
    out[2 * i] = make_uint4(root[0], root[1], root[2], root[3]);
    out[2 * i + 1] = make_uint4(root[4], root[5], root[6], root[7]);
  }
}

}  // namespace

extern "C" int records_root_launch(const void* pubkey_root, const void* credentials,
                                   const void* effective_balance, const void* slashed,
                                   const void* activation_eligibility_epoch,
                                   const void* activation_epoch, const void* exit_epoch,
                                   const void* withdrawable_epoch, const void* index,
                                   void* out, long long n, long long n_rows,
                                   long long length, void* stream) {
  const unsigned blocks = (unsigned)((n + kRecords - 1) / kRecords);
  records_root_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint4*)pubkey_root, (const uint4*)credentials,
      (const unsigned long long*)effective_balance, (const uint8_t*)slashed,
      (const unsigned long long*)activation_eligibility_epoch,
      (const unsigned long long*)activation_epoch, (const unsigned long long*)exit_epoch,
      (const unsigned long long*)withdrawable_epoch, (const long long*)index, (uint4*)out,
      n, n_rows, length);
  return (int)cudaGetLastError();
}
