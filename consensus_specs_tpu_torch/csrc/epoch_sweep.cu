// K1: the phase0 epoch sweep over a struct-of-arrays registry.
//
// Replaces consensus_specs_tpu/parallel/epoch.py:140 _epoch_sweep_impl
// (with :101 _isqrt_u64 and :111 _total): rewards and penalties of the
// source, target and head components, inclusion-delay micro-rewards with
// the proposer scatter-add, the inactivity leak, proportional slashings
// and the effective-balance hysteresis, all in uint64 with the spec's
// wrapping, truncating integer semantics.
//
// The sweep has two grid-wide dependencies (four global sums, then the
// proposer scatter-add), so it is three kernels on one stream:
//   (a) totals_kernel: the four sums, a block reduction per block and one
//       64-bit atomicAdd per sum per block;
//   (b) deltas_kernel: per validator, its rewards (atomically added into
//       new_balance, which starts at zero) and the proposer's share
//       (atomically added at the proposer's row), and its penalties
//       (stored into new_effective_balance);
//   (c) apply_kernel: balance + rewards - penalties with saturation, the
//       slashing penalty and the hysteresis, written over those two rows.
// Integer sums wrap mod 2**64 whatever their order, so the atomics give the
// same bits as the ordered sum.
//
// K24, the sharded sweep (replaces parallel/partition.py:248
// sharded_epoch_step's sweep: epoch.py:111 _total with lax.psum and the
// proposer branch at :190-202), runs the same three kernels on each
// shard's rows with one collective after each of the first two, which
// the host performs (parallel/collectives.py): the shards' four sums are
// all-reduced between (a) and (b); in (b) the proposer's share goes into
// a zeroed accumulator of n_local * D rows, indexed by the global
// proposer index (the drop rule over the global length), and each
// validator's own rewards are stored; the accumulators are
// reduce-scattered between (b) and (c), and (c) adds the shard's reduced
// slice to its rewards.  K1's kernels and epoch_sweep_launch are the
// `false` instances of the same bodies.
//
// Bound on an H100: device memory.  It must read 56 bytes of inputs and
// write 16 per validator, and does a few dozen integer operations and
// about ten 64-bit divisions on them.  The three passes move about 150
// bytes per validator in all; the proposer scatter is random.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

typedef unsigned long long u64;

struct Params {
  u64 base_reward_factor, base_rewards_per_epoch, proposer_reward_quotient,
      inactivity_penalty_quotient, min_epochs_to_inactivity_penalty,
      effective_balance_increment, max_effective_balance, hysteresis_quotient,
      hysteresis_downward_multiplier, hysteresis_upward_multiplier,
      epochs_per_slashings_vector, proportional_slashing_multiplier;
};

struct Scalars {
  u64 current_epoch, finality_delay, slashings_sum;
};

constexpr int kThreads = 256;

__device__ __forceinline__ u64 umax(u64 a, u64 b) { return a < b ? b : a; }
__device__ __forceinline__ u64 umin(u64 a, u64 b) { return b < a ? b : a; }

// The JAX _isqrt_u64 step for step: float64 seed, one guarded Newton step,
// then the exact -1/+1 corrections; exact floor sqrt for n < 2**63.
__device__ __forceinline__ u64 isqrt_u64(u64 n) {
  u64 x = (u64)floor(sqrt((double)n));
  if (x > 0) x = umin(x, (x + n / umax(x, 1)) / 2);
  if (x * x > n) x -= 1;
  if ((x + 1) * (x + 1) <= n) x += 1;
  return x;
}

__device__ __forceinline__ u64 warp_sum(u64 v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// sums[0] = sum of effective balances of validators active this epoch;
// sums[1..3] = sums over unslashed source / target / head attesters.
__global__ void totals_kernel(const u64* __restrict__ eff, const uint8_t* __restrict__ slashed,
                              const u64* __restrict__ act, const u64* __restrict__ exit_e,
                              const uint8_t* __restrict__ src, const uint8_t* __restrict__ tgt,
                              const uint8_t* __restrict__ head, long long n, u64 cur,
                              u64* __restrict__ sums) {
  u64 s[4] = {0, 0, 0, 0};
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    u64 e = eff[i];
    bool uns = !slashed[i];
    if (act[i] <= cur && cur < exit_e[i]) s[0] += e;
    if (src[i] && uns) s[1] += e;
    if (tgt[i] && uns) s[2] += e;
    if (head[i] && uns) s[3] += e;
  }
  __shared__ u64 part[4][kThreads / 32];
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    u64 v = warp_sum(s[k]);
    if (lane == 0) part[k][warp] = v;
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      u64 v = lane < kThreads / 32 ? part[k][lane] : 0;
      v = warp_sum(v);
      if (lane == 0) atomicAdd(&sums[k], v);
    }
  }
}

struct Totals {
  u64 total_active, sqrt_total, attesting[3];
};

__device__ __forceinline__ Totals load_totals(const u64* sums, const Params& p) {
  Totals t;
  u64 incr = p.effective_balance_increment;
  t.total_active = umax(incr, sums[0]);
  t.sqrt_total = isqrt_u64(t.total_active);
  for (int k = 0; k < 3; ++k) t.attesting[k] = umax(incr, sums[k + 1]);
  return t;
}

// kSharded (K24): the proposer's share goes to acc (n_prop rows, the
// global length) and the validator's own rewards are stored; otherwise
// (K1) both are added into rewards, whose n rows are the whole registry.
template <bool kSharded>
__device__ __forceinline__ void deltas_body(const u64* __restrict__ eff, const uint8_t* __restrict__ slashed,
                              const u64* __restrict__ act, const u64* __restrict__ exit_e,
                              const u64* __restrict__ wd, const uint8_t* __restrict__ src,
                              const uint8_t* __restrict__ tgt, const uint8_t* __restrict__ head,
                              const u64* __restrict__ delay, const int32_t* __restrict__ proposer,
                              long long n, Params p, Scalars sc, const u64* __restrict__ sums,
                              u64* __restrict__ rewards, u64* __restrict__ penalties,
                              long long n_prop, u64* __restrict__ acc) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  Totals T = load_totals(sums, p);
  u64 incr = p.effective_balance_increment;
  u64 cur = sc.current_epoch;
  u64 prev = umax(cur, 1) - 1;

  u64 e = eff[i];
  bool sl = slashed[i];
  u64 a = act[i], x = exit_e[i];
  bool active_prev = a <= prev && prev < x;
  bool eligible = active_prev || (sl && prev + 1 < wd[i]);

  u64 base = e * p.base_reward_factor / T.sqrt_total / p.base_rewards_per_epoch;
  u64 prop_reward = base / p.proposer_reward_quotient;
  bool in_leak = sc.finality_delay > p.min_epochs_to_inactivity_penalty;
  bool uns = !sl;
  bool flag[3] = {src[i] && uns, tgt[i] && uns, head[i] && uns};

  u64 rew = 0, pen = 0;
  u64 total_incr = T.total_active / incr;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    u64 part = base * (T.attesting[k] / incr) / total_incr;
    u64 comp = in_leak ? base : part;
    if (eligible && flag[k]) rew += comp;
    if (eligible && !flag[k]) pen += base;
  }
  if (flag[0]) {
    rew += (base - prop_reward) / umax(delay[i], 1);
    // JAX .at[idx].add(mode="drop"): a negative index counts from the end,
    // and an index still outside [0, n) is dropped
    long long j = proposer[i];
    if (j < 0) j += n_prop;
    if (j >= 0 && j < n_prop) atomicAdd(&(kSharded ? acc : rewards)[j], prop_reward);
  }
  if (in_leak && eligible) {
    pen += p.base_rewards_per_epoch * base - prop_reward;
    if (!flag[1]) pen += e * sc.finality_delay / p.inactivity_penalty_quotient;
  }
  if (kSharded) {
    rewards[i] = rew;
  } else {
    atomicAdd(&rewards[i], rew);
  }
  penalties[i] = pen;
}

__global__ void deltas_kernel(const u64* __restrict__ eff, const uint8_t* __restrict__ slashed,
                              const u64* __restrict__ act, const u64* __restrict__ exit_e,
                              const u64* __restrict__ wd, const uint8_t* __restrict__ src,
                              const uint8_t* __restrict__ tgt, const uint8_t* __restrict__ head,
                              const u64* __restrict__ delay, const int32_t* __restrict__ proposer,
                              long long n, Params p, Scalars sc, const u64* __restrict__ sums,
                              u64* __restrict__ rewards, u64* __restrict__ penalties) {
  deltas_body<false>(eff, slashed, act, exit_e, wd, src, tgt, head, delay, proposer, n, p, sc,
                     sums, rewards, penalties, n, nullptr);
}

__global__ void deltas_sharded_kernel(
    const u64* __restrict__ eff, const uint8_t* __restrict__ slashed, const u64* __restrict__ act,
    const u64* __restrict__ exit_e, const u64* __restrict__ wd, const uint8_t* __restrict__ src,
    const uint8_t* __restrict__ tgt, const uint8_t* __restrict__ head,
    const u64* __restrict__ delay, const int32_t* __restrict__ proposer, long long n, Params p,
    Scalars sc, const u64* __restrict__ sums, u64* __restrict__ rewards,
    u64* __restrict__ penalties, long long n_global, u64* __restrict__ acc) {
  deltas_body<true>(eff, slashed, act, exit_e, wd, src, tgt, head, delay, proposer, n, p, sc,
                    sums, rewards, penalties, n_global, acc);
}

// new_balance holds the rewards and new_effective_balance the penalties on
// entry; both are overwritten with the results.  kSharded (K24) adds the
// shard's reduced proposer shares `received` to the rewards.
template <bool kSharded>
__device__ __forceinline__ void apply_body(const u64* __restrict__ bal, const u64* __restrict__ eff,
                             const uint8_t* __restrict__ slashed, const u64* __restrict__ wd,
                             long long n, Params p, Scalars sc, const u64* __restrict__ sums,
                             u64* __restrict__ new_bal, u64* __restrict__ new_eff,
                             const u64* __restrict__ received) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  u64 incr = p.effective_balance_increment;
  u64 total_active = umax(incr, sums[0]);
  u64 cur = sc.current_epoch;
  bool genesis = cur == 0;

  u64 e = eff[i];
  u64 rew = new_bal[i];
  if (kSharded) rew += received[i];
  u64 b = bal[i] + (genesis ? 0 : rew);
  u64 pen = genesis ? 0 : new_eff[i];
  b = pen > b ? 0 : b - pen;

  u64 adj = umin(sc.slashings_sum * p.proportional_slashing_multiplier, total_active);
  bool hits = slashed[i] && cur + p.epochs_per_slashings_vector / 2 == wd[i];
  u64 slash_pen = hits ? (e / incr) * adj / total_active * incr : 0;
  b = slash_pen > b ? 0 : b - slash_pen;

  u64 hyst = incr / p.hysteresis_quotient;
  u64 down = hyst * p.hysteresis_downward_multiplier;
  u64 up = hyst * p.hysteresis_upward_multiplier;
  u64 candidate = umin(b - b % incr, p.max_effective_balance);
  bool move = b + down < e || e + up < b;
  new_eff[i] = move ? candidate : e;
  new_bal[i] = b;
}

__global__ void apply_kernel(const u64* __restrict__ bal, const u64* __restrict__ eff,
                             const uint8_t* __restrict__ slashed, const u64* __restrict__ wd,
                             long long n, Params p, Scalars sc, const u64* __restrict__ sums,
                             u64* __restrict__ new_bal, u64* __restrict__ new_eff) {
  apply_body<false>(bal, eff, slashed, wd, n, p, sc, sums, new_bal, new_eff, nullptr);
}

__global__ void apply_sharded_kernel(const u64* __restrict__ bal, const u64* __restrict__ eff,
                                     const uint8_t* __restrict__ slashed,
                                     const u64* __restrict__ wd, long long n, Params p,
                                     Scalars sc, const u64* __restrict__ sums,
                                     u64* __restrict__ new_bal, u64* __restrict__ new_eff,
                                     const u64* __restrict__ received) {
  apply_body<true>(bal, eff, slashed, wd, n, p, sc, sums, new_bal, new_eff, received);
}

Params unpack_params(const u64* params) {
  Params p;
  p.base_reward_factor = params[0];
  p.base_rewards_per_epoch = params[1];
  p.proposer_reward_quotient = params[2];
  p.inactivity_penalty_quotient = params[3];
  p.min_epochs_to_inactivity_penalty = params[4];
  p.effective_balance_increment = params[5];
  p.max_effective_balance = params[6];
  p.hysteresis_quotient = params[7];
  p.hysteresis_downward_multiplier = params[8];
  p.hysteresis_upward_multiplier = params[9];
  p.epochs_per_slashings_vector = params[10];
  p.proportional_slashing_multiplier = params[11];
  return p;
}

unsigned grid_for(long long n) { return (unsigned)((n + kThreads - 1) / kThreads); }

unsigned totals_grid(long long n) {
  unsigned blocks = grid_for(n);
  return blocks < 132 * 8 ? blocks : 132 * 8;
}

}  // namespace

// params: the 12 EpochParams in field order; scalars: current_epoch,
// finality_delay, slashings_sum; sums: 4 u64 of scratch.
extern "C" int epoch_sweep_launch(const void* bal, const void* eff, const void* slashed,
                                  const void* act, const void* exit_e, const void* wd,
                                  const void* src, const void* tgt, const void* head,
                                  const void* delay, const void* proposer, long long n,
                                  const u64* params, const u64* scalars, void* sums,
                                  void* new_bal, void* new_eff, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  Params p;
  p.base_reward_factor = params[0];
  p.base_rewards_per_epoch = params[1];
  p.proposer_reward_quotient = params[2];
  p.inactivity_penalty_quotient = params[3];
  p.min_epochs_to_inactivity_penalty = params[4];
  p.effective_balance_increment = params[5];
  p.max_effective_balance = params[6];
  p.hysteresis_quotient = params[7];
  p.hysteresis_downward_multiplier = params[8];
  p.hysteresis_upward_multiplier = params[9];
  p.epochs_per_slashings_vector = params[10];
  p.proportional_slashing_multiplier = params[11];
  Scalars sc = {scalars[0], scalars[1], scalars[2]};

  cudaError_t err = cudaMemsetAsync(sums, 0, 4 * sizeof(u64), s);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(new_bal, 0, n * sizeof(u64), s);
  if (err != cudaSuccess) return (int)err;

  unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  unsigned total_blocks = blocks < 132 * 8 ? blocks : 132 * 8;
  const u64* e = (const u64*)eff;
  const uint8_t* sl = (const uint8_t*)slashed;
  totals_kernel<<<total_blocks, kThreads, 0, s>>>(
      e, sl, (const u64*)act, (const u64*)exit_e, (const uint8_t*)src,
      (const uint8_t*)tgt, (const uint8_t*)head, n, sc.current_epoch, (u64*)sums);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  deltas_kernel<<<blocks, kThreads, 0, s>>>(
      e, sl, (const u64*)act, (const u64*)exit_e, (const u64*)wd, (const uint8_t*)src,
      (const uint8_t*)tgt, (const uint8_t*)head, (const u64*)delay,
      (const int32_t*)proposer, n, p, sc, (const u64*)sums, (u64*)new_bal, (u64*)new_eff);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  apply_kernel<<<blocks, kThreads, 0, s>>>((const u64*)bal, e, sl, (const u64*)wd, n, p, sc,
                                           (const u64*)sums, (u64*)new_bal, (u64*)new_eff);
  return (int)cudaGetLastError();
}

// K24 (a): the shard's four sums into sums (4 u64, zeroed here).
extern "C" int epoch_totals_launch(const void* eff, const void* slashed, const void* act,
                                   const void* exit_e, const void* src, const void* tgt,
                                   const void* head, long long n, unsigned long long cur,
                                   void* sums, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(sums, 0, 4 * sizeof(u64), s);
  if (err != cudaSuccess) return (int)err;
  totals_kernel<<<totals_grid(n), kThreads, 0, s>>>(
      (const u64*)eff, (const uint8_t*)slashed, (const u64*)act, (const u64*)exit_e,
      (const uint8_t*)src, (const uint8_t*)tgt, (const uint8_t*)head, n, cur, (u64*)sums);
  return (int)cudaGetLastError();
}

// K24 (b): from the all-reduced sums, the shard's rewards (stored into
// rewards) and penalties, and the proposers' shares added into acc
// (n_global u64, zeroed here) at their global indices.
extern "C" int epoch_deltas_sharded_launch(const void* eff, const void* slashed, const void* act,
                                           const void* exit_e, const void* wd, const void* src,
                                           const void* tgt, const void* head, const void* delay,
                                           const void* proposer, long long n, long long n_global,
                                           const u64* params, const u64* scalars,
                                           const void* sums, void* rewards, void* penalties,
                                           void* acc, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(acc, 0, n_global * sizeof(u64), s);
  if (err != cudaSuccess) return (int)err;
  Scalars sc = {scalars[0], scalars[1], scalars[2]};
  deltas_sharded_kernel<<<grid_for(n), kThreads, 0, s>>>(
      (const u64*)eff, (const uint8_t*)slashed, (const u64*)act, (const u64*)exit_e,
      (const u64*)wd, (const uint8_t*)src, (const uint8_t*)tgt, (const uint8_t*)head,
      (const u64*)delay, (const int32_t*)proposer, n, unpack_params(params), sc,
      (const u64*)sums, (u64*)rewards, (u64*)penalties, n_global, (u64*)acc);
  return (int)cudaGetLastError();
}

// K24 (c): new_bal holds the shard's rewards and new_eff its penalties on
// entry (the buffers of (b)); received is its reduced slice of the
// accumulators.  Both are overwritten with the results.
extern "C" int epoch_apply_sharded_launch(const void* bal, const void* eff, const void* slashed,
                                          const void* wd, long long n, const u64* params,
                                          const u64* scalars, const void* sums,
                                          const void* received, void* new_bal, void* new_eff,
                                          void* stream) {
  Scalars sc = {scalars[0], scalars[1], scalars[2]};
  apply_sharded_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const u64*)bal, (const u64*)eff, (const uint8_t*)slashed, (const u64*)wd, n,
      unpack_params(params), sc, (const u64*)sums, (u64*)new_bal, (u64*)new_eff,
      (const u64*)received);
  return (int)cudaGetLastError();
}
