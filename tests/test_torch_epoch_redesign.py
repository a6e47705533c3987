"""Slice 12's redesigns of K1 and K4, replayed on the CPU and held against
the JAX package, bit for bit (tolerance zero: exact integer arithmetic):

- (a) K1's exact division by invariant divisors: a Python-int replay of
  the device's magic numbers (`make_div`, `div_hi` in
  `csrc/epoch_sweep.cu`: Knuth's two-digit division) and of
  its multiply-high and shifts, against `//` and `%`;
- (b) K1's pass split (the totals with the last block's derivation, the
  proposer-share scatter, the fused rewards and apply), replayed in
  torch int64 with those divisions, against JAX's `epoch_sweep` on the
  flagship's synthetic registry, an odd-branch registry and the edge
  registry (`convert.edge_registry`) at several scalar sets;
- (c) K4's walk (`csrc/incremental.cu` forest_update_kernel under the
  wrapper's `forest_plan`): the scatter, the sparse levels per block or
  per level, the dense chunks through their shared buffers and block 0's
  last levels, one or two forests in one walk, replayed on the port's
  plain SHA-256 against JAX's `update_dirty`.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consensus_specs_tpu.parallel import EpochScalars, epoch_sweep
from consensus_specs_tpu.parallel import incremental as J
from consensus_specs_tpu.parallel.epoch import RegistryArrays
import consensus_specs_tpu_torch as T
from consensus_specs_tpu_torch import convert as C
from consensus_specs_tpu_torch._uint import (i64, shr64, udiv, ule, umax,
                                             umin, ult)
from consensus_specs_tpu_torch.ops.sha256 import sha256_64B_words_plain
from consensus_specs_tpu_torch.parallel import epoch as E
from consensus_specs_tpu_torch.parallel import incremental as P

MASK = 2**64 - 1
M32 = 0xFFFFFFFF


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The replays are many small torch ops: one intra-op thread runs them
    faster and keeps parallel test workers from oversubscribing cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# --- (a) the exact division ---------------------------------------------------


def div_hi(hi: int, d: int) -> int:
    """floor(hi * 2**64 / d) for hi < d, step by step as the device does:
    Knuth's algorithm D on two 32-bit digits of the normalised divisor
    (Hacker's Delight, divlu), in uint64."""
    b = 1 << 32
    s = 64 - d.bit_length()
    d = (d << s) & MASK
    vn1, vn0 = d >> 32, d & M32
    un32 = (hi << s) & MASK
    q1 = un32 // vn1
    rhat = un32 - q1 * vn1
    while q1 >= b or (q1 * vn0) & MASK > (b * rhat) & MASK:
        q1 -= 1
        rhat += vn1
        if rhat >= b:
            break
    un21 = (un32 * b - q1 * d) & MASK
    q0 = un21 // vn1
    rhat = un21 - q0 * vn1
    while q0 >= b or (q0 * vn0) & MASK > (b * rhat) & MASK:
        q0 -= 1
        rhat += vn1
        if rhat >= b:
            break
    return (q1 * b + q0) & MASK


def make_div(d: int):
    """The device's (m, sh1, sh2) for the divisor d >= 1."""
    lg = 0 if d <= 1 else (d - 1).bit_length()
    r = ((0 if lg == 64 else 1 << lg) - d) & MASK
    return (div_hi(r, d) + 1) & MASK, min(lg, 1), max(lg - 1, 0)


def divide(n: int, v) -> int:
    m, sh1, sh2 = v
    t = (m * n) >> 64
    return ((t + ((n - t) >> sh1)) & MASK) >> sh2


_DIVISORS = [1, 2, 3, 5, 7, 10, 2**32 - 1, 2**32, 2**32 + 1, 2**63 - 1,
             2**63, 2**63 + 1, 2**64 - 1,
             # the mainnet params' divisors and the totals' sizes
             T.MAINNET.base_rewards_per_epoch,
             T.MAINNET.proposer_reward_quotient,
             T.MAINNET.inactivity_penalty_quotient,
             T.MAINNET.effective_balance_increment,
             T.MAINNET.hysteresis_quotient,
             math.isqrt(2**20 * 32 * 10**9), 2**20 * 32, 2**20 * 32 * 10**9,
             31622, 33554432000000000]


@pytest.mark.parametrize("d", _DIVISORS)
def test_magic_division_is_exact(d):
    v = make_div(d)
    lg = 0 if d <= 1 else (d - 1).bit_length()
    assert v[0] == (((2**lg - d) << 64) // d + 1) & MASK    # the closed form
    assert 0 < v[0] < 2**64 or d == 1 and v[0] == 1
    rng = np.random.RandomState(d % 2**32)
    ns = [0, 1, 2, d - 1, d, d + 1, 2 * d - 1, 2 * d, MASK, MASK - 1,
          2**63, 2**63 - 1, 2**32 - 1, 2**32]
    ns += [int(x) for x in rng.randint(0, 2**64, 200, dtype=np.uint64)]
    ns += [int(x) for x in rng.randint(0, 2**32, 50, dtype=np.uint64)]
    for n in ns:
        n &= MASK
        q = divide(n, v)
        assert q == n // d, (n, d)
        assert n - q * d == n % d


def test_magic_division_of_wrapping_products():
    """e * base_reward_factor wraps mod 2**64 before the division, on the
    device as in JAX."""
    v = make_div(31622)
    for e in (2**64 - 1, 2**63 + 5, 32 * 10**9, 10**9 - 1):
        n = (e * T.MAINNET.base_reward_factor) & MASK
        assert divide(n, v) == n // 31622


# --- (b) the pass split -------------------------------------------------------


def mulhi(a, b):
    """The high 64 bits of the unsigned product of int64 bit patterns."""
    a0, a1, b0, b1 = a & M32, shr64(a, 32), b & M32, shr64(b, 32)
    p00, p01, p10, p11 = a0 * b0, a0 * b1, a1 * b0, a1 * b1
    mid = shr64(p00, 32) + (p01 & M32) + (p10 & M32)
    return p11 + shr64(p01, 32) + shr64(p10, 32) + shr64(mid, 32)


def tdivide(n, v):
    m, sh1, sh2 = v
    t = mulhi(n, torch.tensor(i64(m), dtype=torch.int64))
    return shr64(t + shr64(n - t, sh1), sh2)


def isqrt_device(n: int) -> int:
    """The device's isqrt_u64: a float64 seed, one guarded Newton step,
    the -1/+1 corrections, in uint64."""
    x = int(math.floor(math.sqrt(float(n))))
    if x > 0:
        x = min(x, (x + n // max(x, 1)) // 2)
    if (x * x) & MASK > n:
        x -= 1
    if ((x + 1) * (x + 1)) & MASK <= n:
        x += 1
    return x


def split_sweep(reg, sc, p):
    """K1 as its three passes compute it, in torch int64: (new_balance,
    new_effective_balance)."""
    n = reg.balance.shape[0]
    c = lambda x: torch.tensor(i64(x & MASK), dtype=torch.int64)  # noqa: E731
    # (a) the four sums; the last block's totals
    sums = [int(s) & MASK for s in E.sweep_totals_plain(reg, sc, n)[0]]
    incr = p.effective_balance_increment
    by_incr = make_div(incr)
    total_active = max(incr, sums[0])
    sqrt_total = isqrt_device(total_active)
    total_incr = divide(total_active, by_incr)
    att_q = [divide(max(incr, s), by_incr) for s in sums[1:]]
    adj = min((sc.slashings_sum * p.proportional_slashing_multiplier) & MASK,
              total_active)
    by_sqrt, by_ti, by_ta = (make_div(sqrt_total),
                             make_div(total_incr), make_div(total_active))
    by_brpe, by_prq, by_ipq = (make_div(p.base_rewards_per_epoch),
                               make_div(p.proposer_reward_quotient),
                               make_div(p.inactivity_penalty_quotient))
    cur = sc.current_epoch
    prev = max(cur, 1) - 1
    in_leak = sc.finality_delay > p.min_epochs_to_inactivity_penalty
    e = reg.effective_balance
    zero = torch.zeros_like(e)
    base = tdivide(tdivide(e * p.base_reward_factor, by_sqrt), by_brpe)
    prop = tdivide(base, by_prq)
    # (b) the proposer shares into the zeroed accumulator
    flags = [reg.is_source & ~reg.slashed, reg.is_target & ~reg.slashed,
             reg.is_head & ~reg.slashed]
    j = reg.proposer_index.to(torch.int64)
    j = torch.where(j < 0, j + n, j)
    keep = flags[0] & (j >= 0) & (j < n)
    acc = torch.zeros(n, dtype=torch.int64).index_add_(
        0, torch.where(keep, j, 0), torch.where(keep, prop, zero))
    # (c) the fused pass: rewards, penalties, the apply
    eligible = ule(reg.activation_epoch, c(prev)) & ult(c(prev),
                                                       reg.exit_epoch)
    eligible |= reg.slashed & ult(c(prev + 1), reg.withdrawable_epoch)
    rew, pen = zero.clone(), zero.clone()
    for f, q in zip(flags, att_q):
        comp = base if in_leak else tdivide(base * c(q), by_ti)
        rew += torch.where(eligible & f, comp, zero)
        pen += torch.where(eligible & ~f, base, zero)
    rew += torch.where(flags[0], udiv(base - prop,
                                      umax(reg.inclusion_delay, 1)), zero)
    if in_leak:
        pen += torch.where(eligible, p.base_rewards_per_epoch * base - prop,
                           zero)
        pen += torch.where(eligible & ~flags[1],
                           tdivide(e * c(sc.finality_delay), by_ipq), zero)
    rew += acc
    genesis = cur == 0
    b = reg.balance + (zero if genesis else rew)
    pen = zero if genesis else pen
    b = torch.where(ult(b, pen), zero, b - pen)
    hits = reg.slashed & (reg.withdrawable_epoch
                          == c(cur + p.epochs_per_slashings_vector // 2))
    slash = tdivide(tdivide(e, by_incr) * c(adj), by_ta) * incr
    b = torch.where(ult(b, torch.where(hits, slash, zero)), zero,
                    b - torch.where(hits, slash, zero))
    hyst = incr // p.hysteresis_quotient
    down = c(hyst * p.hysteresis_downward_multiplier)
    up = c(hyst * p.hysteresis_upward_multiplier)
    cand = umin(tdivide(b, by_incr) * incr, c(p.max_effective_balance))
    move = ult(b + down, e) | ult(e + up, b)
    return b, torch.where(move, cand, e)


def _odd_registry(n):
    reg = C.synthetic_registry(n, 1)
    reg["exit_epoch"][::101] = 99
    reg["exit_epoch"][1::101] = 100
    reg["activation_epoch"][2::101] = 103
    reg["slashed"][::97] = True
    reg["withdrawable_epoch"][::97] = 100 + 8192 // 2
    reg["proposer_index"][::409] = n + 17
    reg["proposer_index"][1::409] = -3
    return reg


_REGISTRIES = {
    "synthetic": lambda: C.synthetic_registry(2**10),
    "odd": lambda: _odd_registry(2**10),
    "edge": lambda: C.edge_registry(2**10),
    "edge single active": lambda: C.edge_registry(2**10, single_active=True),
}
_SCALARS = [(100, 2, 32_000_000_000), (100, 10, 10**13), (0, 0, 0),
            (1, 0, 5 * 10**11), (100, 2, 2**63), (100, 9, 2**64 - 1)]
_SWEEP = jax.jit(lambda r, s: epoch_sweep(r, s, _jax_params()))


def _jax_params():
    from consensus_specs_tpu.parallel import EpochParams

    return EpochParams(**T.MAINNET._asdict())


@pytest.mark.parametrize("name", sorted(_REGISTRIES))
@pytest.mark.parametrize("scalars", _SCALARS)
def test_pass_split_matches_jax(name, scalars):
    reg_np = _REGISTRIES[name]()
    want = _SWEEP(RegistryArrays(**{k: jnp.asarray(v)
                                    for k, v in reg_np.items()}),
                  EpochScalars(*(np.uint64(s) for s in scalars)))
    got = split_sweep(C.registry_to_torch(reg_np, "cpu"),
                      E.EpochScalars(*scalars), T.MAINNET)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(C.u64_to_numpy(g), np.asarray(w))


def test_edge_registry_reaches_the_edges():
    reg = C.edge_registry(2**10)
    eff = reg["effective_balance"]
    assert {0, 1, 10**9 - 1, 2**64 - 1} <= set(eff.tolist())
    assert {0, 1, 2**64 - 1} <= set(reg["inclusion_delay"].tolist())
    one = C.edge_registry(2**10, single_active=True)
    assert (one["activation_epoch"] <= 100).sum() == 1
    # the slashings sum of 2**63 makes adj the whole active balance
    sums, _ = E.sweep_totals_plain(C.registry_to_torch(reg, "cpu"),
                                   E.EpochScalars(100, 2, 2**63), 2**10)
    assert max(10**9, int(sums[0]) & MASK) < 2**63


# --- (c) K4's walk ------------------------------------------------------------


def _hash_rows(state, jobs):
    """One level step of one block: every (forest, level, node, children)
    job's parent = H(children), all read before any is written."""
    if not jobs:
        return []
    blocks = torch.stack([ch for *_, ch in jobs])
    digests = sha256_64B_words_plain(blocks)
    for (f, lvl, p, _), dig in zip(jobs, digests):
        state[f][0][lvl][p] = dig
    return digests


def _run_start(idx, rung, depth, top, j):
    """The device's boundary: the first lane >= j that starts a run of
    the top sparse level's parents, or lies past the forest."""
    while True:
        if j <= 0 or j >= rung or idx[j] >> depth or \
                idx[j - 1] >> top != idx[j] >> top:
            return j
        j += 1


def _sparse_job(layers, idx, depth, lvl, i):
    p = idx[i] >> lvl
    if p >= 1 << (depth - lvl) or (i > 0 and idx[i - 1] >> lvl == p):
        return None
    return (lvl, p, layers[lvl - 1][2 * p:2 * p + 2].reshape(16))


def walk_replay(stacks, co_resident):
    """forest_update_kernel's walk over `stacks` [(layers, idx, words,
    depth)], in place, the blocks one after another."""
    depths = [d for *_, d in stacks]
    rungs = [idx.shape[0] for _, idx, _, _ in stacks]
    plan = P.forest_plan(depths, rungs, co_resident)
    idxs = [[int(x) & MASK for x in idx.tolist()] for _, idx, _, _ in stacks]
    state = [(list(layers), d) for layers, _, _, d in stacks]
    # 0. the scatter, and the order check
    unsorted = False
    for (layers, idx, words, d), ix in zip(stacks, idxs):
        for i, r in enumerate(ix):
            unsorted |= i > 0 and ix[i - 1] > r
            if not r >> d:
                layers[0][r] = words[i]
    # A. the sparse levels
    if not unsorted:
        for b in range(plan.grid):
            for f, ((layers, _, _, d), ix) in enumerate(zip(stacks, idxs)):
                g0, gn = plan.groups[f]
                sp = plan.sparse[f]
                if sp == 0 or not g0 <= b < g0 + gn:
                    continue
                per = -(-rungs[f] // gn)
                q = b - g0
                lo = _run_start(ix, rungs[f], d, sp, q * per) \
                    if q * per < rungs[f] else rungs[f]
                hi = _run_start(ix, rungs[f], d, sp, (q + 1) * per) \
                    if (q + 1) * per < rungs[f] else rungs[f]
                for lvl in range(1, sp + 1):
                    jobs = [(f, *job) for i in range(lo, hi) if (
                        job := _sparse_job(layers, ix, d, lvl, i))]
                    _hash_rows(state, jobs)
    else:
        for lvl in range(1, max(plan.sparse) + 1):
            jobs = [(f, *job) for f, ((layers, _, _, d), ix) in
                    enumerate(zip(stacks, idxs)) if lvl <= plan.sparse[f]
                    for i in range(rungs[f])
                    if (job := _sparse_job(layers, ix, d, lvl, i))]
            _hash_rows(state, jobs)

    def run_chunks(chunks):
        """Chunks [(f, s, k, c)] on one block's threads, a level a step;
        a level's digests kept by thread for the next (the shared
        buffer)."""
        bases, base = [], 0
        for _, _, k, _ in chunks:
            bases.append(base)
            base += 1 << k
        buf = {}
        for lvl_in in range(max(k for _, _, k, _ in chunks) + 1):
            jobs, threads = [], []
            for (f, s, k, c), tb in zip(chunks, bases):
                if lvl_in > k:
                    continue
                layers = state[f][0]
                for off in range(1 << (k - lvl_in)):
                    p = (c << (k - lvl_in)) + off
                    if lvl_in == 0:
                        ch = layers[s - 1][2 * p:2 * p + 2].reshape(16)
                    else:
                        ch = torch.cat([buf[tb + 2 * off],
                                        buf[tb + 2 * off + 1]])
                    jobs.append((f, s + lvl_in, p, ch))
                    threads.append(tb + off)
            buf = dict(zip(threads, _hash_rows(state, jobs)))

    # B. the dense chunks, phase by phase, block by block
    for phase in plan.phases:
        chunks = [(f, *ph, c) for f, (ph, d) in enumerate(zip(phase, depths))
                  if ph for c in range(1 << (d - ph[0] - ph[1]))]
        for b in range(plan.grid):
            for chunk in chunks[b::plan.grid]:
                run_chunks([chunk])
    # C. block 0's last levels
    last = [(f, t, d - t, 0) for f, (t, d) in enumerate(zip(plan.tail, depths))
            if t <= d]
    if last:
        run_chunks(last)
    return plan


def _rand_words(rng, n):
    return rng.randint(0, 2**32, (n, 8), dtype=np.uint64).astype(np.uint32)


def _jax_update(leaves, idx, words, depth):
    layers = J._build_layers(jnp.asarray(leaves), depth)
    return J.update_dirty(layers, jnp.asarray(idx.astype(np.uint32)),
                          jnp.asarray(words), depth)


def _stack(depth, dirty, seed, dup_equal=True):
    """(leaves, padded idx, words) for one forest: the dirty set padded
    with the sentinel to its rung, duplicates with equal words."""
    rng = np.random.RandomState(seed)
    cap = 1 << depth
    leaves = _rand_words(rng, cap)
    idx = P.pad_dirty_idx(np.asarray(dirty, dtype=np.int64), cap).numpy()
    words = _rand_words(rng, idx.shape[0])
    if dup_equal:
        first = {}
        for k, v in enumerate(idx.tolist()):
            words[k] = words[first.setdefault(v, k)]
    return leaves, idx, words


def _port_layers(leaves, depth):
    return list(P.build_layers(C.from_numpy_u32(leaves, "cpu"), depth,
                               plain=True))


def _check_walk(cases, co_resident):
    stacks, wants = [], []
    for depth, dirty, seed in cases:
        leaves, idx, words = _stack(depth, dirty, seed)
        stacks.append((_port_layers(leaves, depth), torch.from_numpy(idx),
                       C.from_numpy_u32(words, "cpu"), depth))
        wants.append(_jax_update(leaves, idx, words, depth))
    plan = walk_replay(stacks, co_resident)
    for (layers, *_), want in zip(stacks, wants):
        assert len(layers) == len(want)
        for k, (g, w) in enumerate(zip(layers, want)):
            np.testing.assert_array_equal(C.words_to_numpy(g), np.asarray(w),
                                          err_msg=f"level {k}")
    return plan


def _sets(depth):
    """test_torch_incremental's fixed sets, scaled to 2**depth leaves,
    and an unsorted set with duplicates."""
    cap = 1 << depth
    sets = {"single first": [0], "single last": [cap - 1],
            "duplicates": [min(7, cap - 1)] * 3,
            "sibling pair": [0, 1][:cap],
            "scattered": sorted({3 % cap, 97 % cap, 200 % cap, 201 % cap}),
            "unsorted with duplicates": [cap - 1, 0, cap // 2, 0, cap - 1]}
    if depth <= 9:
        sets["all dirty"] = list(range(cap))
    return sets


@pytest.mark.parametrize("depth", [0, 1, 4, 9, 12])
def test_walk_replay_matches_jax_update_dirty(depth):
    for seed, (label, dirty) in enumerate(sorted(_sets(depth).items())):
        for co in (1, 3):
            _check_walk([(depth, dirty, seed)], co)


def test_walk_replay_all_dirty_at_depth_12_has_dense_phases():
    plan = _check_walk([(12, list(range(4096)), 5)], 8)
    assert plan.sparse == (0,) and plan.phases and plan.grid == 8


def test_walk_replay_sparse_levels_in_blocks():
    """300 sorted leaves of 2**12 (rung 1024): a sparse level climbed in
    blocks cut at run boundaries, then a dense phase and block 0."""
    rng = np.random.RandomState(9)
    dirty = sorted(rng.choice(4096, 300, replace=False).tolist())
    plan = _check_walk([(12, dirty, 1)], 5)
    assert plan.sparse == (1,) and len(plan.phases) == 1
    dirty = sorted(rng.choice(4096, 40, replace=False).tolist()) + [77, 77]
    plan = _check_walk([(12, sorted(dirty), 2)], 3)
    assert plan.sparse == (5,)


def test_walk_replay_two_forests_in_one_walk():
    rng = np.random.RandomState(4)
    a = sorted(rng.choice(4096, 70, replace=False).tolist())
    b = [3, 4, 100, 511, 511]
    for co in (1, 2, 7):
        plan = _check_walk([(12, a, 1), (9, b, 2)], co)
        assert len(plan.sparse) == 2
    _check_walk([(12, list(range(4096)), 3), (4, [1, 0], 4)], 4)
    _check_walk([(0, [0], 5), (1, [1, 1], 6)], 2)


def test_forest_plan_at_the_step_shapes():
    """The incremental step's two forests (depths 20 and 18, rung 16384)
    on a card with 264 co-resident blocks: 5 and 3 sparse levels, one
    dense phase of 256-node chunks, block 0 from levels 15 and 13."""
    plan = P.forest_plan([20, 18], [16384, 16384], 264)
    assert plan.sparse == (5, 3)
    assert plan.phases == (((6, 8), (4, 8)),)
    assert plan.tail == (15, 13) and plan.grid == 128
    assert plan.groups == ((0, 80), (80, 48))
    assert P.forest_plan([20], [16384], 1).grid == 1
