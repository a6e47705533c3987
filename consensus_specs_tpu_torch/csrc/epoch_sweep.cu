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
//   (a) sweep_totals_kernel: the four sums (a block reduction per block,
//       one 64-bit atomicAdd per sum per block) and a zero in each row of
//       new_balance, which then accumulates the proposer shares; the last
//       block to arrive (a __threadfence and a counter) derives the
//       grid-wide values once: total_active, sqrt_total, total_active /
//       incr, the three attesting / incr quotients, the slashing
//       adjustment, and the division magics of sqrt_total, total_incr and
//       total_active (`Totals`, in a small device scratch);
//   (b) sweep_shares_kernel: each unslashed source attester's proposer
//       share, atomically added at the proposer's row of new_balance
//       (reads effective balance, slashed, source and proposer: 14 bytes);
//   (c) sweep_apply_kernel: per validator, its rewards and penalties,
//       balance + rewards + the shares received - penalties with
//       saturation, the slashing penalty and the hysteresis, stored over
//       new_balance and new_effective_balance.
// Integer sums wrap mod 2**64 whatever their order, so the atomics give the
// same bits as the ordered sum.  About 126 bytes move per validator in all
// (36 in (a), 14 in (b) besides the shares' atomics, 76 in (c)); each
// thread takes 4 consecutive validators, with the uint64 fields loaded as
// two 16-byte vectors and the four flags of one field as one 32-bit word.
//
// Division: every divisor but max(delay, 1) is the same across the grid,
// and the card has no 64-bit integer divider (a u64 `/` compiles to a
// routine of tens of instructions).  So each such quotient is a
// multiply-high by a magic number and two shifts (`Div`, exact for every
// uint64 dividend: Granlund and Montgomery 1994, figure 4.1), the params'
// magics made on the host by the launcher, the totals' on the card by the
// last block of (a).  Products that wrap mod 2**64 before a division
// (e * base_reward_factor) wrap as before.  `/ max(delay, 1)` stays a real
// divide, a 32-bit one where both operands fit.
//
// K24, the sharded sweep (replaces parallel/partition.py:248
// sharded_epoch_step's sweep: epoch.py:111 _total with lax.psum and the
// proposer branch at :190-202), is K1's pass split on each shard's rows,
// with one collective after each of its first two kernels, which the host
// performs (parallel/collectives.py), and no memset:
//   (a) shard_totals_kernel: the shard's four sums, which are all-reduced,
//       and a zero in each of the n_local * D rows of the shard's
//       proposer accumulator; the last block writes the sums out and puts
//       back the zeros of the accumulated sums and of its arrival counter
//       (a per-device `ShardScratch`, zeroed once by the wrapper);
//   (b) shard_shares_kernel: K1's proposer shares into the accumulator,
//       indexed by the global proposer index (the drop rule over the
//       global length); the accumulators are reduce-scattered.  Each
//       block needs only the square root's magic, made by thread 0 while
//       the block's loads are in flight; the last block derives every
//       grid-wide value once (`Totals`, into a small per-shard buffer);
//   (c) sweep_apply_kernel, K1's (c): the rewards and penalties in place,
//       plus the shard's reduced slice of the accumulators, applied.
// About 118 bytes move per local row besides the shares' atomics (28 in
// (a), 14 in (b), 76 in (c)), and 8 D a row of the accumulator's zeroes.
//
// Bound on an H100: device memory.  The sweep must read 56 bytes of inputs
// and write 16 per validator; the proposer scatter is random.
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 256;
constexpr int kPer = 4;                    // validators a thread
constexpr int kTotalsBlocks = 132 * 4;   // one wave of (a)

// Exact n / d for a divisor d >= 1 fixed across the grid (Granlund and
// Montgomery 1994, figure 4.1, N = 64): with l = ceil(log2 d),
// m = floor(2**64 (2**l - d) / d) + 1, sh1 = min(l, 1), sh2 = max(l - 1, 0),
// t = mulhi(m, n): n / d = (t + ((n - t) >> sh1)) >> sh2 for every u64 n.
struct Div {
  u64 m;
  unsigned sh1, sh2;
};

__host__ __device__ inline int clz64(u64 x) {
#ifdef __CUDA_ARCH__
  return __clzll((long long)x);
#else
  return x ? __builtin_clzll(x) : 64;
#endif
}

// floor(hi * 2**64 / d) for hi < d: Knuth's algorithm D on two 32-bit
// digits (Hacker's Delight, divlu), the divisor normalised so that its top
// bit is set; each digit's estimate from a 64 / 32-bit quotient, corrected
// at most twice.  A few hundred cycles, against some 2,000 for a 64-step
// restoring loop.
__host__ __device__ inline u64 div_hi(u64 hi, u64 d) {
  const u64 b = 1ull << 32;
  const int s = clz64(d);
  d <<= s;
  const u64 vn1 = d >> 32, vn0 = d & 0xffffffffull;
  const u64 un32 = hi << s;                  // hi < d: nothing shifts out
  u64 q1 = un32 / vn1, rhat = un32 - q1 * vn1;
  while (q1 >= b || q1 * vn0 > b * rhat) {
    q1 -= 1;
    rhat += vn1;
    if (rhat >= b) break;
  }
  const u64 un21 = un32 * b - q1 * d;        // mod 2**64: the remainder
  u64 q0 = un21 / vn1;
  rhat = un21 - q0 * vn1;
  while (q0 >= b || q0 * vn0 > b * rhat) {
    q0 -= 1;
    rhat += vn1;
    if (rhat >= b) break;
  }
  return q1 * b + q0;
}

__host__ __device__ inline unsigned ceil_log2(u64 d) {
  return d <= 1 ? 0 : 64 - clz64(d - 1);
}

__host__ __device__ inline Div make_div(u64 d) {
  unsigned l = ceil_log2(d);
  u64 r = (l == 64 ? 0ull : 1ull << l) - d;   // 2**l - d, below d
  Div v;
  v.m = div_hi(r, d) + 1;
  v.sh1 = l < 1 ? l : 1;
  v.sh2 = l > 0 ? l - 1 : 0;
  return v;
}

__device__ __forceinline__ u64 divide(u64 n, const Div& d) {
  u64 t = __umul64hi(d.m, n);
  return (t + ((n - t) >> d.sh1)) >> d.sh2;
}

__host__ __device__ inline u64 umax(u64 a, u64 b) { return a < b ? b : a; }
__host__ __device__ inline u64 umin(u64 a, u64 b) { return b < a ? b : a; }

// The JAX _isqrt_u64 step for step: float64 seed, one guarded Newton step,
// then the exact -1/+1 corrections; exact floor sqrt for n < 2**63.
__device__ __forceinline__ u64 isqrt_u64(u64 n) {
  u64 x = (u64)floor(sqrt((double)n));
  if (x > 0) x = umin(x, (x + n / umax(x, 1)) / 2);
  if (x * x > n) x -= 1;
  if ((x + 1) * (x + 1) <= n) x += 1;
  return x;
}

// The params and scalars as the bodies use them, made on the host.
struct Consts {
  u64 brf, brpe, incr, max_eb, hyst_down, hyst_up;
  u64 cur, prev, finality_delay, slash_epoch, slash_num;
  Div by_brpe, by_prq, by_incr, by_ipq;
  int in_leak, genesis;
};

// The grid-wide values of one sweep, from the four global sums.  K24 hands
// them from (b) to (c) as kTotalsWords int64 words (TOTALS_WORDS in
// parallel/epoch.py, whose plain phases write the same words): the seven
// values, then each magic as m and sh1 | sh2 << 32.
struct Totals {
  u64 total_active, sqrt_total, total_incr, att_q[3], adj;
  Div by_sqrt, by_total_incr, by_total_active;
};
constexpr int kTotalsWords = 13;
static_assert(sizeof(Totals) == kTotalsWords * 8, "Totals' layout");

// K24's scratch on a device: the sums' accumulators and the arrival
// counters of (a) and (b), zero between launches (each launch's last block
// puts back the zeros it found).
struct ShardScratch {
  u64 sums[4];
  unsigned arrived_totals, arrived_shares;
};

// K1's device scratch: the sums and arrival counter (zeroed by the
// launcher), then the totals the last block of (a) derives.
struct Scratch {
  u64 sums[4];
  unsigned arrived, pad;
  Totals t;
};

// The totals from the four global sums, by warp 0: kDeltas, what the
// rewards and penalties need (sqrt_total, the attesting quotients and
// their magics), kApply, what the apply needs (adj and total_active's
// magic).  The magics are made at once in lanes 0-2 (lane 0's after the
// square root); lane 0's result is the one to use.
template <bool kDeltas, bool kApply>
__device__ __forceinline__ Totals derive(const u64 sums[4], const Consts& c) {
  Totals t = {};
  int lane = threadIdx.x & 31;
  t.total_active = umax(c.incr, sums[0]);
  t.adj = umin(c.slash_num, t.total_active);
  if (kDeltas) {
    t.sqrt_total = isqrt_u64(t.total_active);
    t.total_incr = divide(t.total_active, c.by_incr);
    for (int k = 0; k < 3; ++k) t.att_q[k] = divide(umax(c.incr, sums[k + 1]), c.by_incr);
  }
  u64 d = !kDeltas || lane == 2 ? t.total_active : lane == 0 ? t.sqrt_total : t.total_incr;
  Div mine = make_div(d);
  Div* out[3] = {kDeltas ? &t.by_sqrt : &t.by_total_active, &t.by_total_incr,
                 &t.by_total_active};
  for (int k = 0; k < (kDeltas ? (kApply ? 3 : 2) : 1); ++k) {
    out[k]->m = __shfl_sync(0xffffffffu, mine.m, k);
    out[k]->sh1 = __shfl_sync(0xffffffffu, mine.sh1, k);
    out[k]->sh2 = __shfl_sync(0xffffffffu, mine.sh2, k);
  }
  return t;
}

// --- loads and stores of kPer consecutive rows -------------------------------

__device__ __forceinline__ void ld4(const u64* __restrict__ p, long long i, long long n,
                                    u64 v[kPer]) {
  if (i + 3 < n) {
    ulonglong2 a = __ldg(reinterpret_cast<const ulonglong2*>(p + i));
    ulonglong2 b = __ldg(reinterpret_cast<const ulonglong2*>(p + i + 2));
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
  } else {
#pragma unroll
    for (int k = 0; k < kPer; ++k) v[k] = i + k < n ? p[i + k] : 0;
  }
}

// rows that this kernel writes: coherent loads, no read-only cache
__device__ __forceinline__ void ld4_rw(const u64* p, long long i, long long n, u64 v[kPer]) {
  if (i + 3 < n) {
    ulonglong2 a = *reinterpret_cast<const ulonglong2*>(p + i);
    ulonglong2 b = *reinterpret_cast<const ulonglong2*>(p + i + 2);
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
  } else {
#pragma unroll
    for (int k = 0; k < kPer; ++k) v[k] = i + k < n ? p[i + k] : 0;
  }
}

__device__ __forceinline__ void st4(u64* p, long long i, long long n, const u64 v[kPer]) {
  if (i + 3 < n) {
    *reinterpret_cast<ulonglong2*>(p + i) = make_ulonglong2(v[0], v[1]);
    *reinterpret_cast<ulonglong2*>(p + i + 2) = make_ulonglong2(v[2], v[3]);
  } else {
#pragma unroll
    for (int k = 0; k < kPer; ++k)
      if (i + k < n) p[i + k] = v[k];
  }
}

// the byte flags of rows i .. i + 3, byte k of the result for row i + k
__device__ __forceinline__ unsigned ld4_u8(const uint8_t* __restrict__ p, long long i,
                                           long long n) {
  if (i + 3 < n) return __ldg(reinterpret_cast<const unsigned*>(p + i));
  unsigned r = 0;
#pragma unroll
  for (int k = 0; k < kPer; ++k)
    if (i + k < n) r |= (unsigned)p[i + k] << (8 * k);
  return r;
}

__device__ __forceinline__ void ld4_i32(const int32_t* __restrict__ p, long long i, long long n,
                                        int32_t v[kPer]) {
  if (i + 3 < n) {
    int4 a = __ldg(reinterpret_cast<const int4*>(p + i));
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  } else {
#pragma unroll
    for (int k = 0; k < kPer; ++k) v[k] = i + k < n ? p[i + k] : 0;
  }
}

__device__ __forceinline__ bool bit(unsigned flags, int k) { return (flags >> (8 * k)) & 0xffu; }

__device__ __forceinline__ u64 warp_sum(u64 v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// The block's four sums, reduced into thread 0's s[].
__device__ __forceinline__ void block_sum4(u64 s[4]) {
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
    for (int k = 0; k < 4; ++k) s[k] = warp_sum(lane < kThreads / 32 ? part[k][lane] : 0);
  }
}

// --- (a): the four sums -------------------------------------------------------

// sums[0] = sum of effective balances of validators active this epoch;
// sums[1..3] = sums over unslashed source / target / head attesters: the
// block's, reduced into thread 0's s[].  Also a zero in each of acc's
// n_acc rows: beside the sums where n_acc is the registry's length
// (kZeroBeside, K1's new_balance), in a loop of its own otherwise (K24's
// accumulator of n_local * D rows).
template <bool kZeroBeside>
__device__ __forceinline__ void block_sums(const u64* __restrict__ eff,
                                           const uint8_t* __restrict__ slashed,
                                           const u64* __restrict__ act,
                                           const u64* __restrict__ exit_e,
                                           const uint8_t* __restrict__ src,
                                           const uint8_t* __restrict__ tgt,
                                           const uint8_t* __restrict__ head, long long n,
                                           u64 cur, u64* acc, long long n_acc, u64 s[4]) {
  const u64 zero[kPer] = {0, 0, 0, 0};
  const long long stride = kPer * (long long)gridDim.x * blockDim.x;
  s[0] = s[1] = s[2] = s[3] = 0;
  for (long long i = kPer * (blockIdx.x * (long long)blockDim.x + threadIdx.x); i < n;
       i += stride) {
    u64 e[kPer], a[kPer], x[kPer];
    ld4(eff, i, n, e);
    ld4(act, i, n, a);
    ld4(exit_e, i, n, x);
    unsigned sl = ld4_u8(slashed, i, n), fs = ld4_u8(src, i, n), ft = ld4_u8(tgt, i, n),
             fh = ld4_u8(head, i, n);
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      bool uns = !bit(sl, k);
      if (a[k] <= cur && cur < x[k]) s[0] += e[k];
      if (bit(fs, k) && uns) s[1] += e[k];
      if (bit(ft, k) && uns) s[2] += e[k];
      if (bit(fh, k) && uns) s[3] += e[k];
    }
    if (kZeroBeside) st4(acc, i, n, zero);
  }
  if (!kZeroBeside)
    for (long long i = kPer * (blockIdx.x * (long long)blockDim.x + threadIdx.x); i < n_acc;
         i += stride)
      st4(acc, i, n_acc, zero);
  block_sum4(s);
}

// Whether this block is the last of its launch to arrive, in every thread
// of the block: thread 0 adds the block's sums s[] into acc_sums (where
// given), fences, and counts the block in at *arrived.
__device__ __forceinline__ bool arrive_last(const u64 s[4], u64* acc_sums, unsigned* arrived) {
  __shared__ bool last;
  if (threadIdx.x == 0) {
    if (acc_sums)
      for (int k = 0; k < 4; ++k) atomicAdd(&acc_sums[k], s[k]);
    __threadfence();
    last = atomicAdd(arrived, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  return last;
}

// --- the per-validator bodies ----------------------------------------------------

__device__ __forceinline__ u64 base_reward(u64 e, const Consts& c, const Div& by_sqrt) {
  return divide(divide(e * c.brf, by_sqrt), c.by_brpe);
}

// (base - prop) / max(delay, 1): the one divisor that changes per validator
__device__ __forceinline__ u64 delay_div(u64 x, u64 delay) {
  u64 d = umax(delay, 1);
  if (((x | d) >> 32) == 0) return (unsigned)x / (unsigned)d;
  return x / d;
}

// Validator rows i .. i + 3: their rewards (without proposer shares
// received) and penalties.
__device__ __forceinline__ void deltas4(unsigned sl, const u64* __restrict__ act,
                                        const u64* __restrict__ exit_e,
                                        const u64* __restrict__ wd, unsigned fs, unsigned ft,
                                        unsigned fh, const u64* __restrict__ delay, long long i,
                                        long long n, const Consts& c, const Totals& t,
                                        const u64 e[kPer], u64 rew[kPer], u64 pen[kPer]) {
  u64 a[kPer], x[kPer], w[kPer], dl[kPer];
  ld4(act, i, n, a);
  ld4(exit_e, i, n, x);
  ld4(wd, i, n, w);
  ld4(delay, i, n, dl);
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    bool s = bit(sl, k);
    bool eligible = (a[k] <= c.prev && c.prev < x[k]) || (s && c.prev + 1 < w[k]);
    u64 base = base_reward(e[k], c, t.by_sqrt);
    u64 prop = divide(base, c.by_prq);
    bool flag[3] = {bit(fs, k) && !s, bit(ft, k) && !s, bit(fh, k) && !s};
    u64 r = 0, p = 0;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      u64 comp = c.in_leak ? base : divide(base * t.att_q[j], t.by_total_incr);
      if (eligible && flag[j]) r += comp;
      if (eligible && !flag[j]) p += base;
    }
    if (flag[0]) r += delay_div(base - prop, dl[k]);
    if (c.in_leak && eligible) {
      p += c.brpe * base - prop;
      if (!flag[1]) p += divide(e[k] * c.finality_delay, c.by_ipq);
    }
    rew[k] = r;
    pen[k] = p;
  }
}

// The proposer shares of rows i .. i + 3 (their proposers pj) into acc
// (n_prop rows).  JAX .at[idx].add(mode="drop"): a negative index counts
// from the end, and an index still outside [0, n_prop) is dropped.
__device__ __forceinline__ void shares4(const u64 e[kPer], unsigned sl, unsigned fs,
                                        const int32_t pj[kPer], long long i, long long n,
                                        const Consts& c, const Div& by_sqrt, long long n_prop,
                                        u64* acc) {
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    if (i + k >= n || !bit(fs, k) || bit(sl, k)) continue;
    long long j = pj[k];
    if (j < 0) j += n_prop;
    if (j >= 0 && j < n_prop)
      atomicAdd(&acc[j], divide(base_reward(e[k], c, by_sqrt), c.by_prq));
  }
}

// balance + rew - pen with saturation, the slashing penalty, the
// hysteresis: (new balance, new effective balance) of rows i .. i + 3.
__device__ __forceinline__ void apply4(const u64* __restrict__ bal, const u64 e[kPer],
                                       unsigned sl, const u64* __restrict__ wd, long long i,
                                       long long n, const Consts& c, const Totals& t,
                                       const u64 rew[kPer], const u64 pen[kPer], u64 nb[kPer],
                                       u64 ne[kPer]) {
  u64 b0[kPer], w[kPer];
  ld4(bal, i, n, b0);
  ld4(wd, i, n, w);
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    u64 b = b0[k] + (c.genesis ? 0 : rew[k]);
    u64 p = c.genesis ? 0 : pen[k];
    b = p > b ? 0 : b - p;
    bool hits = bit(sl, k) && c.slash_epoch == w[k];
    u64 slash_pen =
        hits ? divide(divide(e[k], c.by_incr) * t.adj, t.by_total_active) * c.incr : 0;
    b = slash_pen > b ? 0 : b - slash_pen;
    u64 candidate = umin(divide(b, c.by_incr) * c.incr, c.max_eb);
    bool move = b + c.hyst_down < e[k] || e[k] + c.hyst_up < b;
    ne[k] = move ? candidate : e[k];
    nb[k] = b;
  }
}

__device__ __forceinline__ long long first_row() {
  return kPer * (blockIdx.x * (long long)blockDim.x + threadIdx.x);
}

// --- K1 ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
    sweep_totals_kernel(const u64* __restrict__ eff, const uint8_t* __restrict__ slashed,
                        const u64* __restrict__ act, const u64* __restrict__ exit_e,
                        const uint8_t* __restrict__ src, const uint8_t* __restrict__ tgt,
                        const uint8_t* __restrict__ head, long long n, Consts c,
                        u64* new_bal, Scratch* scratch) {
  u64 s[4];
  block_sums<true>(eff, slashed, act, exit_e, src, tgt, head, n, c.cur, new_bal, n, s);
  if (arrive_last(s, scratch->sums, &scratch->arrived) && threadIdx.x < 32) {
    __threadfence();
    u64 total[4];
    for (int k = 0; k < 4; ++k) total[k] = atomicAdd(&scratch->sums[k], 0ull);
    Totals t = derive<true, true>(total, c);
    if (threadIdx.x == 0) scratch->t = t;
  }
}

__global__ void __launch_bounds__(kThreads)
    sweep_shares_kernel(const u64* __restrict__ eff, const uint8_t* __restrict__ slashed,
                        const uint8_t* __restrict__ src, const int32_t* __restrict__ proposer,
                        long long n, Consts c, const Scratch* __restrict__ scratch,
                        u64* new_bal) {
  long long i = first_row();
  if (i >= n) return;
  const Div by_sqrt = scratch->t.by_sqrt;
  u64 e[kPer];
  int32_t pj[kPer];
  ld4(eff, i, n, e);
  ld4_i32(proposer, i, n, pj);
  shares4(e, ld4_u8(slashed, i, n), ld4_u8(src, i, n), pj, i, n, c, by_sqrt, n, new_bal);
}

// K1's (c) and K24's: received holds the proposer shares each row received
// (K1: new_bal itself, which (a) zeroed and (b) accumulated into).
__global__ void __launch_bounds__(kThreads)
    sweep_apply_kernel(const u64* __restrict__ bal, const u64* __restrict__ eff,
                       const uint8_t* __restrict__ slashed, const u64* __restrict__ act,
                       const u64* __restrict__ exit_e, const u64* __restrict__ wd,
                       const uint8_t* __restrict__ src, const uint8_t* __restrict__ tgt,
                       const uint8_t* __restrict__ head, const u64* __restrict__ delay,
                       long long n, Consts c, const Totals* __restrict__ totals,
                       const u64* received, u64* new_bal, u64* __restrict__ new_eff) {
  long long i = first_row();
  if (i >= n) return;
  const Totals t = *totals;
  u64 e[kPer], rew[kPer], pen[kPer], got[kPer], nb[kPer], ne[kPer];
  ld4(eff, i, n, e);
  unsigned sl = ld4_u8(slashed, i, n);
  deltas4(sl, act, exit_e, wd, ld4_u8(src, i, n), ld4_u8(tgt, i, n), ld4_u8(head, i, n), delay,
          i, n, c, t, e, rew, pen);
  ld4_rw(received, i, n, got);
#pragma unroll
  for (int k = 0; k < kPer; ++k) rew[k] += got[k];
  apply4(bal, e, sl, wd, i, n, c, t, rew, pen, nb, ne);
  st4(new_bal, i, n, nb);
  st4(new_eff, i, n, ne);
}

// --- K24 --------------------------------------------------------------------------

// (a): the shard's sums into sums (4 u64) and zeros into acc's n_acc rows.
__global__ void __launch_bounds__(kThreads)
    shard_totals_kernel(const u64* __restrict__ eff, const uint8_t* __restrict__ slashed,
                        const u64* __restrict__ act, const u64* __restrict__ exit_e,
                        const uint8_t* __restrict__ src, const uint8_t* __restrict__ tgt,
                        const uint8_t* __restrict__ head, long long n, u64 cur, u64* acc,
                        long long n_acc, ShardScratch* scratch, u64* __restrict__ sums) {
  u64 s[4];
  block_sums<false>(eff, slashed, act, exit_e, src, tgt, head, n, cur, acc, n_acc, s);
  if (arrive_last(s, scratch->sums, &scratch->arrived_totals) && threadIdx.x == 0) {
    __threadfence();
    for (int k = 0; k < 4; ++k) sums[k] = atomicExch(&scratch->sums[k], 0ull);
    atomicExch(&scratch->arrived_totals, 0u);
  }
}

// (b): the shares of the shard's rows into acc (n_global rows) from the
// all-reduced sums; the last block writes the grid-wide values to totals.
__global__ void __launch_bounds__(kThreads)
    shard_shares_kernel(const u64* __restrict__ eff, const uint8_t* __restrict__ slashed,
                        const uint8_t* __restrict__ src, const int32_t* __restrict__ proposer,
                        long long n, Consts c, const u64* __restrict__ sums,
                        long long n_global, u64* acc, ShardScratch* scratch,
                        Totals* __restrict__ totals) {
  const long long i = first_row();
  const bool live = i < n;
  u64 e[kPer] = {0, 0, 0, 0};
  int32_t pj[kPer] = {0, 0, 0, 0};
  unsigned sl = 0, fs = 0;
  if (live) {   // in flight while thread 0 makes the magic
    ld4(eff, i, n, e);
    ld4_i32(proposer, i, n, pj);
    sl = ld4_u8(slashed, i, n);
    fs = ld4_u8(src, i, n);
  }
  __shared__ Div by_sqrt;
  if (threadIdx.x == 0) by_sqrt = make_div(isqrt_u64(umax(c.incr, sums[0])));
  __syncthreads();
  if (live) shares4(e, sl, fs, pj, i, n, c, by_sqrt, n_global, acc);
  const u64 none[4] = {0, 0, 0, 0};
  if (arrive_last(none, nullptr, &scratch->arrived_shares) && threadIdx.x < 32) {
    u64 s[4] = {sums[0], sums[1], sums[2], sums[3]};
    Totals t = derive<true, true>(s, c);
    if (threadIdx.x == 0) {
      *totals = t;
      atomicExch(&scratch->arrived_shares, 0u);
    }
  }
}

// A probe, on no path: clock64() cycles of one block's prelude in (b)
// (thread 0's square root and its magic), of the per-block derivations of
// the parent design's (b) and (c) by warp 0, and of the last block's
// whole derivation, for the all-reduced active balance `total`.
__global__ void prelude_probe_kernel(u64 total, Consts c, long long* out) {
  const u64 s[4] = {total, total, total, total};
  long long t0 = clock64();
  Div by_sqrt = {};
  if (threadIdx.x == 0) by_sqrt = make_div(isqrt_u64(umax(c.incr, total)));
  __syncwarp();
  long long t1 = clock64();
  Totals d = derive<true, false>(s, c);
  __syncwarp();
  long long t2 = clock64();
  Totals a = derive<false, true>(s, c);
  __syncwarp();
  long long t3 = clock64();
  Totals f = derive<true, true>(s, c);
  __syncwarp();
  long long t4 = clock64();
  if (threadIdx.x == 0) {
    out[0] = t1 - t0;
    out[1] = t2 - t1;
    out[2] = t3 - t2;
    out[3] = t4 - t3;
    out[4] = (long long)(by_sqrt.m ^ d.by_sqrt.m ^ a.by_total_active.m ^ f.by_total_incr.m);
  }
}

// --- host side --------------------------------------------------------------------

// params: the 12 EpochParams in field order; scalars: current_epoch,
// finality_delay, slashings_sum.  The divisors (base_rewards_per_epoch,
// proposer_reward_quotient, effective_balance_increment,
// inactivity_penalty_quotient, hysteresis_quotient) must be nonzero.
Consts make_consts(const u64* params, const u64* scalars) {
  Consts c = {};
  u64 brf = params[0], brpe = params[1], prq = params[2], ipq = params[3];
  u64 min_leak = params[4], incr = params[5], max_eb = params[6], hq = params[7];
  u64 down = params[8], up = params[9], epsv = params[10], psm = params[11];
  c.brf = brf;
  c.brpe = brpe;
  c.incr = incr;
  c.max_eb = max_eb;
  u64 hyst = incr / hq;
  c.hyst_down = hyst * down;
  c.hyst_up = hyst * up;
  c.cur = scalars[0];
  c.prev = umax(c.cur, 1) - 1;
  c.finality_delay = scalars[1];
  c.slash_epoch = c.cur + epsv / 2;
  c.slash_num = scalars[2] * psm;
  c.by_brpe = make_div(brpe);
  c.by_prq = make_div(prq);
  c.by_incr = make_div(incr);
  c.by_ipq = make_div(ipq);
  c.in_leak = scalars[1] > min_leak;
  c.genesis = c.cur == 0;
  return c;
}

unsigned grid_for(long long n) {
  long long groups = (n + kPer - 1) / kPer;
  return (unsigned)((groups + kThreads - 1) / kThreads);
}

unsigned totals_grid(long long n) {
  unsigned blocks = grid_for(n);
  return blocks < kTotalsBlocks ? blocks : kTotalsBlocks;
}

}  // namespace

// Bytes of K1's device scratch (`scratch` below).
extern "C" long long epoch_sweep_scratch_bytes() { return (long long)sizeof(Scratch); }

// K1: scratch is epoch_sweep_scratch_bytes() of device memory; every
// pointer 16-byte aligned.
extern "C" int epoch_sweep_launch(const void* bal, const void* eff, const void* slashed,
                                  const void* act, const void* exit_e, const void* wd,
                                  const void* src, const void* tgt, const void* head,
                                  const void* delay, const void* proposer, long long n,
                                  const u64* params, const u64* scalars, void* scratch,
                                  void* new_bal, void* new_eff, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  Consts c = make_consts(params, scalars);
  cudaError_t err = cudaMemsetAsync(scratch, 0, offsetof(Scratch, t), s);
  if (err != cudaSuccess) return (int)err;
  const u64* e = (const u64*)eff;
  const uint8_t* sl = (const uint8_t*)slashed;
  const uint8_t* fs = (const uint8_t*)src;
  Scratch* sc = (Scratch*)scratch;
  sweep_totals_kernel<<<totals_grid(n), kThreads, 0, s>>>(
      e, sl, (const u64*)act, (const u64*)exit_e, fs, (const uint8_t*)tgt,
      (const uint8_t*)head, n, c, (u64*)new_bal, sc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sweep_shares_kernel<<<grid_for(n), kThreads, 0, s>>>(e, sl, fs, (const int32_t*)proposer, n,
                                                       c, sc, (u64*)new_bal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sweep_apply_kernel<<<grid_for(n), kThreads, 0, s>>>(
      (const u64*)bal, e, sl, (const u64*)act, (const u64*)exit_e, (const u64*)wd, fs,
      (const uint8_t*)tgt, (const uint8_t*)head, (const u64*)delay, n, c, &sc->t,
      (const u64*)new_bal, (u64*)new_bal, (u64*)new_eff);
  return (int)cudaGetLastError();
}

// Bytes of K24's per-device scratch, zero on entry to and return from
// each of its launches.
extern "C" long long epoch_shard_scratch_bytes() { return (long long)sizeof(ShardScratch); }

// K24 (a): the shard's four sums into sums (4 u64) and zeros into acc's
// n_acc rows (the shard's accumulator of (b)).
extern "C" int epoch_shard_totals_launch(const void* eff, const void* slashed, const void* act,
                                         const void* exit_e, const void* src, const void* tgt,
                                         const void* head, long long n, unsigned long long cur,
                                         void* acc, long long n_acc, void* scratch, void* sums,
                                         void* stream) {
  shard_totals_kernel<<<totals_grid(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const u64*)eff, (const uint8_t*)slashed, (const u64*)act, (const u64*)exit_e,
      (const uint8_t*)src, (const uint8_t*)tgt, (const uint8_t*)head, n, cur, (u64*)acc, n_acc,
      (ShardScratch*)scratch, (u64*)sums);
  return (int)cudaGetLastError();
}

// K24 (b): from the all-reduced sums, the proposers' shares of the shard's
// rows added into acc (n_global u64, zeroed by (a)) at their global
// indices, and the grid-wide values into totals (kTotalsWords u64).
extern "C" int epoch_shard_shares_launch(const void* eff, const void* slashed, const void* src,
                                         const void* proposer, long long n, long long n_global,
                                         const u64* params, const u64* scalars,
                                         const void* sums, void* acc, void* scratch,
                                         void* totals, void* stream) {
  shard_shares_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const u64*)eff, (const uint8_t*)slashed, (const uint8_t*)src, (const int32_t*)proposer,
      n, make_consts(params, scalars), (const u64*)sums, n_global, (u64*)acc,
      (ShardScratch*)scratch, (Totals*)totals);
  return (int)cudaGetLastError();
}

// K24 (c): K1's (c) on the shard from the totals of (b) and its reduced
// slice of the accumulators, received.
extern "C" int epoch_shard_apply_launch(const void* bal, const void* eff, const void* slashed,
                                        const void* act, const void* exit_e, const void* wd,
                                        const void* src, const void* tgt, const void* head,
                                        const void* delay, long long n, const u64* params,
                                        const u64* scalars, const void* totals,
                                        const void* received, void* new_bal, void* new_eff,
                                        void* stream) {
  sweep_apply_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const u64*)bal, (const u64*)eff, (const uint8_t*)slashed, (const u64*)act,
      (const u64*)exit_e, (const u64*)wd, (const uint8_t*)src, (const uint8_t*)tgt,
      (const uint8_t*)head, (const u64*)delay, n, make_consts(params, scalars),
      (const Totals*)totals, (const u64*)received, (u64*)new_bal, (u64*)new_eff);
  return (int)cudaGetLastError();
}

// The prelude probe (on no path): out receives 5 int64 (the cycles of the
// four derivations, a checksum).
extern "C" int epoch_prelude_probe_launch(unsigned long long total, const u64* params,
                                          const u64* scalars, void* out, void* stream) {
  prelude_probe_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(total, make_consts(params, scalars),
                                                           (long long*)out);
  return (int)cudaGetLastError();
}
