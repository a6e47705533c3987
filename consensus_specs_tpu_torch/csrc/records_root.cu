// K3: hash_tree_root of each Validator record, one thread per validator.
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
// of gathering seven arrays first.
//
// Bound on an H100: integer issue, as K2 (sha256.cu): 7 messages of about
// 2,300 integer instructions each against 137 bytes read and written per
// validator.  The leaves are built in registers, so the 256-byte leaf
// level and the two interior levels never reach device memory.
#include <cuda_runtime.h>

#include <cstdint>

#include "sha256.cuh"

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ void put_u64_leaf(uint32_t* w, unsigned long long v) {
  w[0] = cst::bswap32((uint32_t)v);
  w[1] = cst::bswap32((uint32_t)(v >> 32));
#pragma unroll
  for (int k = 2; k < 8; ++k) w[k] = 0;
}

// out[0..8) = SHA-256(leaf(x) || leaf(y)) for two uint64 field leaves.
__device__ __forceinline__ void hash_u64_pair(unsigned long long x, unsigned long long y,
                                              uint32_t* out) {
  uint32_t w[16];
  put_u64_leaf(w, x);
  put_u64_leaf(w + 8, y);
  cst::sha256_64B(w, out);
}

__device__ __forceinline__ void hash_node_pair(const uint32_t* l, const uint32_t* r,
                                               uint32_t* out) {
  uint32_t w[16];
#pragma unroll
  for (int k = 0; k < 8; ++k) { w[k] = l[k]; w[8 + k] = r[k]; }
  cst::sha256_64B(w, out);
}

__global__ void records_root_kernel(
    const uint4* __restrict__ pubkey_root, const uint4* __restrict__ credentials,
    const unsigned long long* __restrict__ effective_balance,
    const uint8_t* __restrict__ slashed,
    const unsigned long long* __restrict__ activation_eligibility_epoch,
    const unsigned long long* __restrict__ activation_epoch,
    const unsigned long long* __restrict__ exit_epoch,
    const unsigned long long* __restrict__ withdrawable_epoch,
    const long long* __restrict__ index, uint4* __restrict__ out, long long n,
    long long n_rows, long long length) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  if (i >= length) {
    out[2 * i] = make_uint4(0, 0, 0, 0);
    out[2 * i + 1] = make_uint4(0, 0, 0, 0);
    return;
  }
  long long r = i;
  if (index != nullptr) {
    unsigned long long x = (unsigned long long)index[i];
    r = x < (unsigned long long)n_rows ? (long long)x : n_rows - 1;
  }
  uint32_t h01[8], h23[8], h45[8], h67[8];
  {
    uint32_t w[16];
    uint4 a = pubkey_root[2 * r], b = pubkey_root[2 * r + 1];
    uint4 c = credentials[2 * r], d = credentials[2 * r + 1];
    w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
    w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
    w[8] = c.x; w[9] = c.y; w[10] = c.z; w[11] = c.w;
    w[12] = d.x; w[13] = d.y; w[14] = d.z; w[15] = d.w;
    cst::sha256_64B(w, h01);
  }
  hash_u64_pair(effective_balance[r], slashed[r] ? 1ull : 0ull, h23);
  hash_u64_pair(activation_eligibility_epoch[r], activation_epoch[r], h45);
  hash_u64_pair(exit_epoch[r], withdrawable_epoch[r], h67);
  uint32_t h0123[8], h4567[8], root[8];
  hash_node_pair(h01, h23, h0123);
  hash_node_pair(h45, h67, h4567);
  hash_node_pair(h0123, h4567, root);
  out[2 * i] = make_uint4(root[0], root[1], root[2], root[3]);
  out[2 * i + 1] = make_uint4(root[4], root[5], root[6], root[7]);
}

}  // namespace

extern "C" int records_root_launch(const void* pubkey_root, const void* credentials,
                                   const void* effective_balance, const void* slashed,
                                   const void* activation_eligibility_epoch,
                                   const void* activation_epoch, const void* exit_epoch,
                                   const void* withdrawable_epoch, const void* index,
                                   void* out, long long n, long long n_rows,
                                   long long length, void* stream) {
  unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  records_root_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint4*)pubkey_root, (const uint4*)credentials,
      (const unsigned long long*)effective_balance, (const uint8_t*)slashed,
      (const unsigned long long*)activation_eligibility_epoch,
      (const unsigned long long*)activation_epoch, (const unsigned long long*)exit_epoch,
      (const unsigned long long*)withdrawable_epoch, (const long long*)index, (uint4*)out,
      n, n_rows, length);
  return (int)cudaGetLastError();
}
