"""The redesigned K24 (the sharded epoch sweep) replayed on the CPU and held
against the JAX package, bit for bit (tolerance zero: exact integer
arithmetic).

K24 (`csrc/epoch_sweep.cu`) is K1's pass split on each shard, with the
host's collectives between the passes and no memset:

- (a) the shard's four sums, wrapping mod 2**64, written out by the last
  block, and zeros in the shard's accumulator of n_local * D rows;
- the sums all-reduced;
- (b) each block's square root of the all-reduced active balance and its
  magic (`make_div` on Knuth's two-digit division: a Python model here,
  against exact `//`), the proposer shares scattered into the accumulator by the
  global index (JAX's drop rule over n_local * D), and the last block's
  derivation of every grid-wide value (`Totals`, 13 words);
- the accumulators reduce-scattered;
- (c) K1's apply from those words and the shard's reduced slice.

`sharded_replay` runs that schedule in torch int64 with the device's
divisions (`test_torch_epoch_redesign.py`'s replay of `make_div`) at D =
1, 2, 4 and 8, against JAX's `epoch_sweep` under `shard_map` on the
forced CPU devices and JAX's unsharded `epoch_sweep`, on that file's
registries, a registry whose attesters name 32 proposers, and one whose
proposers are negative, equal to n_local * D or above it, with the leak
off and on and at genesis.  The port's plain phases (`derive_totals`,
`magic`, the plain sharded sweep) are held to the same words, and the
source's constants and launcher signatures to `parallel/epoch.py`.
"""

import functools
import re
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JSpec
from test_torch_epoch_redesign import (MASK, _REGISTRIES, _jax_params,
                                       div_hi, divide, isqrt_device,
                                       make_div, tdivide)

from consensus_specs_tpu.parallel import EpochScalars, epoch_sweep
from consensus_specs_tpu.parallel import partition as JP
from consensus_specs_tpu.parallel.epoch import RegistryArrays
from consensus_specs_tpu.utils.jaxtools import shard_map_compat
import consensus_specs_tpu_torch as T
from consensus_specs_tpu_torch import convert as C
from consensus_specs_tpu_torch._uint import i64, udiv, ule, umax, umin, ult
from consensus_specs_tpu_torch.parallel import epoch as E

SOURCE = Path(E.__file__).resolve().parents[1] / "csrc" / "epoch_sweep.cu"
N = 2**10


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# --- the replay ---------------------------------------------------------------


def _c(x):
    return torch.tensor(i64(x & MASK), dtype=torch.int64)


def _magic_words(v):
    m, sh1, sh2 = v
    return [m, sh1 | sh2 << 32]


def shard_sums(reg, cur: int):
    """(a)'s four sums of one shard, mod 2**64."""
    e = reg.effective_balance
    zero = torch.zeros_like(e)
    uns = ~reg.slashed
    masks = [ule(reg.activation_epoch, _c(cur)) & ult(_c(cur), reg.exit_epoch),
             reg.is_source & uns, reg.is_target & uns, reg.is_head & uns]
    return [int(torch.where(m, e, zero).sum()) & MASK for m in masks]


def last_block_totals(sums, sc, p):
    """(b)'s last block: the 13 words of `Totals` from the all-reduced
    sums, with the device's divisions."""
    incr = p.effective_balance_increment
    by_incr = make_div(incr)
    total_active = max(incr, sums[0])
    sqrt_total = isqrt_device(total_active)
    total_incr = divide(total_active, by_incr)
    att_q = [divide(max(incr, s), by_incr) for s in sums[1:]]
    adj = min((sc.slashings_sum * p.proportional_slashing_multiplier) & MASK,
              total_active)
    words = [total_active, sqrt_total, total_incr, *att_q, adj]
    for d in (sqrt_total, total_incr, total_active):
        words += _magic_words(make_div(d))
    return words


def block_shares(reg, sc, p, sums, acc):
    """(b)'s blocks: the square root's magic from the all-reduced active
    balance, then each unslashed source attester's share into acc by the
    drop rule over acc's length."""
    by_sqrt = make_div(isqrt_device(max(p.effective_balance_increment,
                                        sums[0])))
    e = reg.effective_balance
    base = tdivide(tdivide(e * p.base_reward_factor, by_sqrt),
                   make_div(p.base_rewards_per_epoch))
    prop = tdivide(base, make_div(p.proposer_reward_quotient))
    n_prop = acc.shape[0]
    j = reg.proposer_index.to(torch.int64)
    j = torch.where(j < 0, j + n_prop, j)
    keep = reg.is_source & ~reg.slashed & (j >= 0) & (j < n_prop)
    acc.index_add_(0, torch.where(keep, j, 0),
                   torch.where(keep, prop, torch.zeros_like(prop)))


def apply_pass(reg, sc, p, words, received):
    """(c), K1's apply pass: rewards and penalties from the words, plus
    the shares received, applied."""
    total_active, sqrt_total, total_incr = words[:3]
    att_q, adj = words[3:6], words[6]
    by_sqrt, by_ti, by_ta = (make_div(sqrt_total), make_div(total_incr),
                             make_div(total_active))
    assert [words[7], words[9], words[11]] == [by_sqrt[0], by_ti[0],
                                               by_ta[0]]
    by_incr, by_brpe, by_prq, by_ipq = (
        make_div(p.effective_balance_increment),
        make_div(p.base_rewards_per_epoch),
        make_div(p.proposer_reward_quotient),
        make_div(p.inactivity_penalty_quotient))
    incr = p.effective_balance_increment
    cur = sc.current_epoch
    prev = max(cur, 1) - 1
    in_leak = sc.finality_delay > p.min_epochs_to_inactivity_penalty
    e = reg.effective_balance
    zero = torch.zeros_like(e)
    base = tdivide(tdivide(e * p.base_reward_factor, by_sqrt), by_brpe)
    prop = tdivide(base, by_prq)
    flags = [reg.is_source & ~reg.slashed, reg.is_target & ~reg.slashed,
             reg.is_head & ~reg.slashed]
    eligible = ule(reg.activation_epoch, _c(prev)) & ult(_c(prev),
                                                         reg.exit_epoch)
    eligible |= reg.slashed & ult(_c(prev + 1), reg.withdrawable_epoch)
    rew, pen = zero.clone(), zero.clone()
    for f, q in zip(flags, att_q):
        comp = base if in_leak else tdivide(base * _c(q), by_ti)
        rew += torch.where(eligible & f, comp, zero)
        pen += torch.where(eligible & ~f, base, zero)
    rew += torch.where(flags[0], udiv(base - prop,
                                      umax(reg.inclusion_delay, 1)), zero)
    if in_leak:
        pen += torch.where(eligible, p.base_rewards_per_epoch * base - prop,
                           zero)
        pen += torch.where(eligible & ~flags[1],
                           tdivide(e * _c(sc.finality_delay), by_ipq), zero)
    rew += received
    genesis = cur == 0
    b = reg.balance + (zero if genesis else rew)
    pen = zero if genesis else pen
    b = torch.where(ult(b, pen), zero, b - pen)
    hits = reg.slashed & (reg.withdrawable_epoch
                          == _c(cur + p.epochs_per_slashings_vector // 2))
    slash = torch.where(hits, tdivide(tdivide(e, by_incr) * _c(adj), by_ta)
                        * incr, zero)
    b = torch.where(ult(b, slash), zero, b - slash)
    hyst = incr // p.hysteresis_quotient
    down = _c(hyst * p.hysteresis_downward_multiplier)
    up = _c(hyst * p.hysteresis_upward_multiplier)
    cand = umin(tdivide(b, by_incr) * incr, _c(p.max_effective_balance))
    move = ult(b + down, e) | ult(e + up, b)
    return b, torch.where(move, cand, e)


def sharded_replay(reg_np, d: int, sc, p):
    """K24 over d shards as its kernels and the host's collectives compute
    it: the shards' (new_balance, new_effective_balance) concatenated,
    and each shard's 13 words of (b)."""
    full = C.registry_to_torch(reg_np, "cpu")
    n_global = full.balance.shape[0]
    n = n_global // d
    shards = [E.RegistryArrays(*(f[k * n:(k + 1) * n] for f in full))
              for k in range(d)]
    # (a): the shards' sums and zeroed accumulators; the all-reduce
    local = [shard_sums(r, sc.current_epoch) for r in shards]
    sums = [sum(s[k] for s in local) & MASK for k in range(4)]
    accs = [torch.zeros(n_global, dtype=torch.int64) for _ in shards]
    # (b): the blocks' shares, the last block's words; the reduce-scatter
    words = []
    for r, acc in zip(shards, accs):
        block_shares(r, sc, p, sums, acc)
        words.append(last_block_totals(sums, sc, p))
    received = [sum(a[k * n:(k + 1) * n] for a in accs) for k in range(d)]
    # (c)
    out = [apply_pass(r, sc, p, w, got)
           for r, w, got in zip(shards, words, received)]
    return (torch.cat([b for b, _ in out]), torch.cat([e for _, e in out]),
            words)


# --- the registries and the JAX side ------------------------------------------


def _hot_registry(n):
    """Every attester's proposer among 32 validators (two epochs of
    slots), as in a mainnet epoch; they lie in every shard."""
    reg = C.synthetic_registry(n, 3)
    reg["proposer_index"] = C.hot_proposers(n, 32, seed=4)
    return reg


def _range_registry(n):
    """Proposers in other shards, negative (down to -n, which is index 0),
    equal to n and above it, and below -n (dropped)."""
    reg = C.synthetic_registry(n, 6)
    prop = reg["proposer_index"]
    prop[::5] = (np.arange(0, n, 5) + n // 2) % n
    prop[1::7] = -1
    prop[2::11] = -n
    prop[3::13] = n
    prop[4::17] = n + 9
    prop[5::19] = -n - 1
    prop[6::23] = 2**31 - 1
    prop[7::29] = -(2**31)
    reg["slashed"][::31] = True
    return reg


REGISTRIES = dict(_REGISTRIES, **{"hot proposers": lambda: _hot_registry(N),
                                  "proposer range": lambda: _range_registry(N)})
SCALARS = {"no leak": (100, 2, 32_000_000_000),
           "leak": (100, 10, 10**13),
           "genesis": (0, 0, 0)}
WIDTHS = (1, 2, 4, 8)


def _jax_reg(reg_np):
    return RegistryArrays(**{k: jnp.asarray(v) for k, v in reg_np.items()})


@functools.cache
def _jax_sharded(d: int):
    """JAX's sweep over d forced CPU devices, as its sharded step runs it
    (`epoch_sweep(..., axis_name)` under `shard_map`)."""
    mesh = JP.build_mesh(n_devices=d, require_pow2=True)
    axis = mesh.axis_names[0]
    row = JSpec(axis)
    reg_spec = RegistryArrays(*([row] * len(RegistryArrays._fields)))
    sc_spec = EpochScalars(*([JSpec()] * len(EpochScalars._fields)))
    params = _jax_params()
    fn = shard_map_compat(
        lambda r, s: epoch_sweep(r, s, params, axis_name=axis), mesh=mesh,
        in_specs=(reg_spec, sc_spec), out_specs=(row, row))
    return jax.jit(fn)


_UNSHARDED = jax.jit(lambda r, s: epoch_sweep(r, s, _jax_params()))


@functools.cache
def _jax_want(name: str, scalars: tuple):
    reg_np = REGISTRIES[name]()
    sc = EpochScalars(*(np.uint64(s) for s in scalars))
    want = [np.asarray(w) for w in _UNSHARDED(_jax_reg(reg_np), sc)]
    return reg_np, sc, want


# --- the tests --------------------------------------------------------------


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("scal", sorted(SCALARS))
@pytest.mark.parametrize("name", sorted(REGISTRIES))
def test_sharded_replay_matches_jax(name, scal, d):
    reg_np, jsc, want = _jax_want(name, SCALARS[scal])
    sharded = _jax_sharded(d)(_jax_reg(reg_np), jsc)
    for s, w in zip(sharded, want):
        np.testing.assert_array_equal(np.asarray(s), w)
    sc = E.EpochScalars(*SCALARS[scal])
    bal, eff, words = sharded_replay(reg_np, d, sc, T.MAINNET)
    np.testing.assert_array_equal(C.u64_to_numpy(bal), want[0])
    np.testing.assert_array_equal(C.u64_to_numpy(eff), want[1])
    # the plain phases write the words the kernel's last block writes
    full = C.registry_to_torch(reg_np, "cpu")
    sums = [sum(shard_sums(E.RegistryArrays(*(f[k * N // d:(k + 1) * N // d]
                                              for f in full)),
                           sc.current_epoch)[j] for k in range(d)) & MASK
            for j in range(4)]
    assert E.derive_totals(sums, sc, T.MAINNET) == words[0]
    assert all(w == words[0] for w in words)


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("name", ["hot proposers", "proposer range", "odd"])
def test_plain_phases_follow_the_split(name, d):
    """The port's plain phases, shard by shard with the collectives, give
    the replay's words, accumulators and outputs; the plain sharded sweep
    gives JAX's."""
    from consensus_specs_tpu_torch import parallel as P
    from consensus_specs_tpu_torch.parallel import collectives as CO

    reg_np, _, want = _jax_want(name, SCALARS["leak"])
    sc = E.EpochScalars(*SCALARS["leak"])
    regs = P.shard_registry(P.make_mesh(devices=["cpu"] * d),
                            C.registry_to_torch(reg_np, "cpu"))
    parts = [E.sweep_totals_plain(r, sc, N) for r in regs]
    assert all(torch.equal(a, torch.zeros(N, dtype=torch.int64))
               for _, a in parts)
    sums = CO.all_reduce_sum([s for s, _ in parts])
    totals = [E.sweep_shares_plain(r, sc, T.MAINNET, s, a)
              for r, s, (_, a) in zip(regs, sums, parts)]
    _, _, words = sharded_replay(reg_np, d, sc, T.MAINNET)
    assert all(t.dtype == torch.int64 and t.shape == (E.TOTALS_WORDS,)
               for t in totals)
    assert [[int(v) & MASK for v in t] for t in totals] == words
    received = CO.reduce_scatter_sum([a for _, a in parts])
    out = [E.sweep_apply_plain(r, sc, T.MAINNET, t, g)
           for r, t, g in zip(regs, totals, received)]
    np.testing.assert_array_equal(
        C.u64_to_numpy(torch.cat([b for b, _ in out])), want[0])
    bal, eff = E.epoch_sweep_sharded(regs, sc, T.MAINNET)
    np.testing.assert_array_equal(C.u64_to_numpy(torch.cat(bal)), want[0])
    np.testing.assert_array_equal(C.u64_to_numpy(torch.cat(eff)), want[1])


def test_hot_registry_has_32_proposers():
    reg = _hot_registry(N)
    assert np.unique(reg["proposer_index"]).size == 32
    src = reg["is_source"] & ~reg["slashed"]
    assert np.unique(reg["proposer_index"][src]).size == 32


_DIVISORS = [1, 2, 3, 5, 7, 31622, 2**64 - 1, 2**63 - 1, 2**63 + 1]
_DIVISORS += [2**k + dk for k in (1, 2, 5, 16, 31, 32, 33, 47, 62, 63)
              for dk in (-1, 0, 1)]


@pytest.mark.parametrize("d", sorted(set(_DIVISORS)))
def test_magic_words_divide_exactly(d):
    """`epoch.magic`, the closed form the plain phases write, equals the
    device's `make_div` (its `div_hi` replayed), and its quotients equal
    exact `//`."""
    m, sh = E.magic(d)
    assert _magic_words(make_div(d)) == [m, sh]
    v = (m, sh & 0xFFFFFFFF, sh >> 32)
    rng = np.random.RandomState(d % 2**32)
    ns = [0, 1, d - 1, d, d + 1, 2 * d - 1, MASK, MASK - 1, 2**63, 2**63 - 1]
    ns += [int(x) for x in rng.randint(0, 2**64, 100, dtype=np.uint64)]
    for n in ns:
        n &= MASK
        assert divide(n, v) == n // d, (n, d)


@pytest.mark.parametrize("d", sorted(set(_DIVISORS)))
def test_knuth_div_hi_is_exact(d):
    """The device's `div_hi` (Knuth's two-digit division, replayed step by
    step) equals floor(hi * 2**64 / d) for every hi < d tried: 0, 1, the
    top, the powers of two below d and random ones."""
    rng = np.random.RandomState(d % 2**31)
    his = {0, 1, d - 1, d // 2, (d - 1) >> 1} | {
        1 << k for k in range(64) if 1 << k < d}
    his |= {int(x) % d for x in rng.randint(0, 2**64, 300, dtype=np.uint64)}
    for hi in sorted(h for h in his if 0 <= h < d):
        assert div_hi(hi, d) == (hi << 64) // d, (hi, d)


@pytest.mark.parametrize("n", [0, 1, 2, 3, 4, 10**9, 32 * 10**9 * 2**20,
                               2**62, 2**63 - 1, 2**64 - 1])
def test_isqrt_matches_the_device(n):
    assert E._isqrt(n) == isqrt_device(n)
    if n < 2**63:
        assert E._isqrt(n) ** 2 <= n < (E._isqrt(n) + 1) ** 2


def test_derive_totals_edges():
    """Sums below an increment count as one; the slashing adjustment is
    capped by the active balance and wraps with its product."""
    p = T.MAINNET
    incr = p.effective_balance_increment
    w = E.derive_totals([0, 0, 0, 0], E.EpochScalars(5, 0, 0), p)
    assert w[:7] == [incr, isqrt_device(incr), 1, 1, 1, 1, 0]
    w = E.derive_totals([MASK, 5, MASK, 0], E.EpochScalars(5, 0, 2**63), p)
    assert w[0] == MASK and w[3:6] == [1, MASK // incr, 1]
    assert w[6] == (2**63 * p.proportional_slashing_multiplier) & MASK
    assert w == last_block_totals([MASK, 5, MASK, 0],
                                  E.EpochScalars(5, 0, 2**63), p)


def _launcher_params(text: str, name: str) -> int:
    m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", text)
    assert m, name
    return len([a for a in m.group(1).split(",") if a.strip()])


def test_constants_and_signatures_match_the_source(monkeypatch):
    text = SOURCE.read_text()
    m = re.search(r"constexpr int kTotalsWords = (\d+);", text)
    assert m and int(m.group(1)) == E.TOTALS_WORDS
    fields = re.search(r"struct Totals \{\s*u64 ([^;]*);\s*Div ([^;]*);",
                       text)
    assert [f.strip() for f in fields.group(1).split(",")] == [
        "total_active", "sqrt_total", "total_incr", "att_q[3]", "adj"]
    assert [f.strip() for f in fields.group(2).split(",")] == [
        "by_sqrt", "by_total_incr", "by_total_active"]
    assert re.search(r"struct Div \{\s*u64 m;\s*unsigned sh1, sh2;\s*\};",
                     text)
    counts = {"epoch_shard_totals_launch": 14,
              "epoch_shard_shares_launch": 13,
              "epoch_shard_apply_launch": 18,
              "epoch_prelude_probe_launch": 5}
    for name, k in counts.items():
        assert _launcher_params(text, name) == k
    # and the wrappers' argtypes, from `_lib` on a stand-in library
    fake = _FakeLib()
    monkeypatch.setattr(E._build, "load", lambda name: fake)
    E._lib.__wrapped__()
    for name, k in counts.items():
        assert len(fake.fns[name].argtypes) == k, name


class _FakeLib:
    """Records the attributes `_lib` sets on each function."""

    def __init__(self):
        self.fns = {}

    def __getattr__(self, name):
        return self.fns.setdefault(name, types.SimpleNamespace())
