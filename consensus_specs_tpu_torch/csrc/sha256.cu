// K2: SHA-256 of N 64-byte messages, one thread per message.
//
// Replaces consensus_specs_tpu/ops/sha256_jax.py:100 sha256_64B_words
// (with hash_pairs, _compress_loop, _compress_unrolled) and, in leaf mode,
// the first level of parallel/merkle.py:68 subtree_root over
// parallel/merkle.py:45 pack_u64_chunks.
//
// Bound on an H100: the ALU pipe.  A message is two compressions, 2,300
// 32-bit integer instructions in this kernel's sm_90a SASS (rotations as
// funnel shifts, three-input adds and logic), 2,084 of them on the ALU
// pipe (64 lanes an SM a clock; 198 IMAD on the FMA pipe, 18 VIADD on
// either), against 96 bytes of
// device memory traffic, so the ALU pipe bounds it long before the memory
// rate does (chip_smoke.py `sha_message_mix` counts them).  The
// design keeps the whole state and the 16-word rolling schedule in
// registers, fully unrolled, and never touches shared memory.
#include <cuda_runtime.h>

#include <cstdint>

#include "sha256.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void sha256_64B_kernel(const uint4* __restrict__ in,
                                  uint4* __restrict__ out, long long n) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t w[16], d[8];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    uint4 v = in[4 * i + q];
    w[4 * q] = v.x; w[4 * q + 1] = v.y; w[4 * q + 2] = v.z; w[4 * q + 3] = v.w;
  }
  cst::sha256_64B(w, d);
  out[2 * i] = make_uint4(d[0], d[1], d[2], d[3]);
  out[2 * i + 1] = make_uint4(d[4], d[5], d[6], d[7]);
}

// Message i packs the uint64 values 8i .. 8i+7 as two SSZ chunks: each
// value is 8 little-endian bytes, i.e. the big-endian words
// bswap32(low half), bswap32(high half).  Values past n_vals are zero.
__global__ void sha256_u64_leaves_kernel(const unsigned long long* __restrict__ vals,
                                         uint4* __restrict__ out, long long n_msgs,
                                         long long n_vals) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n_msgs) return;
  uint32_t w[16], d[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    long long k = 8 * i + j;
    unsigned long long v = k < n_vals ? vals[k] : 0ull;
    w[2 * j] = cst::bswap32((uint32_t)v);
    w[2 * j + 1] = cst::bswap32((uint32_t)(v >> 32));
  }
  cst::sha256_64B(w, d);
  out[2 * i] = make_uint4(d[0], d[1], d[2], d[3]);
  out[2 * i + 1] = make_uint4(d[4], d[5], d[6], d[7]);
}

unsigned blocks_for(long long n) { return (unsigned)((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" int sha256_64B_launch(const void* in, void* out, long long n, void* stream) {
  sha256_64B_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint4*)in, (uint4*)out, n);
  return (int)cudaGetLastError();
}

extern "C" int sha256_u64_leaves_launch(const void* vals, void* out, long long n_msgs,
                                        long long n_vals, void* stream) {
  sha256_u64_leaves_kernel<<<blocks_for(n_msgs), kThreads, 0, (cudaStream_t)stream>>>(
      (const unsigned long long*)vals, (uint4*)out, n_msgs, n_vals);
  return (int)cudaGetLastError();
}
