"""The phase0 epoch sweep (counterpart of
`consensus_specs_tpu.parallel.epoch`), with kernel K1.

The registry is a struct of (N,) tensors.  uint64 fields are int64 bit
patterns and every unsigned comparison, division and saturation goes
through `_uint`, so the plain version gives the JAX sweep's bits for any
input, `FAR_FUTURE_EPOCH` exits included.

`epoch_sweep` runs the plain version for CPU tensors and launches K1
(`csrc/epoch_sweep.cu`) for CUDA tensors.  `epoch_sweep_sharded` runs the
sweep over D shards, each phase on each shard's device (K24, the same
source's sharded launchers, or the plain phases), with the collectives
of `parallel/collectives.py` between the phases.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from .. import _build
from .._uint import i64, udiv, ule, ult, umax, umin, umod
from ..params import EpochParams
from .collectives import all_reduce_sum, on, reduce_scatter_sum


class RegistryArrays(NamedTuple):
    """Struct-of-arrays registry and previous-epoch participation for one
    epoch transition; all (N,) on one device.  Same fields as the JAX
    `RegistryArrays`."""

    balance: torch.Tensor                       # int64 (uint64 Gwei)
    effective_balance: torch.Tensor             # int64 (uint64 Gwei)
    slashed: torch.Tensor                       # bool
    activation_eligibility_epoch: torch.Tensor  # int64 (uint64)
    activation_epoch: torch.Tensor              # int64 (uint64)
    exit_epoch: torch.Tensor                    # int64 (uint64)
    withdrawable_epoch: torch.Tensor            # int64 (uint64)
    is_source: torch.Tensor                     # bool
    is_target: torch.Tensor                     # bool
    is_head: torch.Tensor                       # bool
    inclusion_delay: torch.Tensor               # int64 (uint64)
    proposer_index: torch.Tensor                # int32


_DTYPES = {"slashed": torch.bool, "is_source": torch.bool,
           "is_target": torch.bool, "is_head": torch.bool,
           "proposer_index": torch.int32}


class EpochScalars(NamedTuple):
    """Per-epoch scalars as Python ints in [0, 2**64) (the JAX side's
    uint64 0-d arrays; they come from the host state)."""

    current_epoch: int
    finality_delay: int       # previous_epoch - finalized.epoch
    slashings_sum: int        # sum(state.slashings)


# --- plain PyTorch version ----------------------------------------------------


_MASK = 2**64 - 1

# int64 words of the grid-wide values that K24's (b) hands to (c)
# (`kTotalsWords`, the `Totals` struct of csrc/epoch_sweep.cu): total
# active balance, its square root, total_active / increment, the three
# attesting / increment quotients, the slashing adjustment, then the
# division magics (m, sh1 | sh2 << 32) of the square root, total_incr and
# total_active.
TOTALS_WORDS = 13


def _isqrt(n: int) -> int:
    """The JAX `_isqrt_u64` step for step on a Python int in [0, 2**64):
    float64 seed, a guarded Newton step, then -1/+1 fixes, in uint64."""
    x = math.floor(math.sqrt(float(n)))
    if x > 0:
        x = min(x, (x + n // max(x, 1)) // 2)
    if (x * x) & _MASK > n:
        x -= 1
    if ((x + 1) * (x + 1)) & _MASK <= n:
        x += 1
    return x


def magic(d: int) -> tuple:
    """The kernels' exact division by d >= 1 (`make_div`: Granlund and
    Montgomery 1994, figure 4.1) as two words: m = floor(2**64 (2**l - d)
    / d) + 1 mod 2**64 and sh1 | sh2 << 32, with l = ceil(log2 d), sh1 =
    min(l, 1), sh2 = max(l - 1, 0)."""
    lg = (d - 1).bit_length() if d > 1 else 0
    m = ((((1 << lg) - d) << 64) // d + 1) & _MASK
    return m, min(lg, 1) | max(lg - 1, 0) << 32


def derive_totals(sums, sc: EpochScalars, params: EpochParams) -> list:
    """The TOTALS_WORDS grid-wide values, as uint64 Python ints, from the
    all-reduced sums (a (4,) int64 tensor or four ints)."""
    s = [int(v) & _MASK for v in sums]
    incr = params.effective_balance_increment
    total_active = max(incr, s[0])
    sqrt_total = _isqrt(total_active)
    words = [total_active, sqrt_total, total_active // incr,
             *(max(incr, v) // incr for v in s[1:]),
             min((sc.slashings_sum * params.proportional_slashing_multiplier)
                 & _MASK, total_active)]
    for d in (sqrt_total, words[2], total_active):
        words += magic(d)
    return words


def _c(x, dev):
    """A uint64 constant as a 0-d int64 tensor on `dev`."""
    return torch.tensor(i64(x), dtype=torch.int64, device=dev)


def _flags(reg: RegistryArrays):
    unslashed = ~reg.slashed
    return [reg.is_source & unslashed, reg.is_target & unslashed,
            reg.is_head & unslashed]


def sweep_totals_plain(reg: RegistryArrays, sc: EpochScalars,
                       n_global: int):
    """(a): the (4,) int64 sums over the registry of the effective
    balances of the validators active this epoch, and of the unslashed
    source, target and head attesters (JAX `_total`'s local `jnp.sum`),
    and a zero proposer-share accumulator of `n_global` rows for (b).
    Returns (sums, acc)."""
    eff = reg.effective_balance
    zero = torch.zeros_like(eff)
    cur = _c(sc.current_epoch, eff.device)
    active_cur = ule(reg.activation_epoch, cur) & ult(cur, reg.exit_epoch)
    sums = torch.stack([torch.where(m, eff, zero).sum()
                        for m in [active_cur] + _flags(reg)])
    return sums, torch.zeros(n_global, dtype=torch.int64, device=eff.device)


def _base_reward(reg: RegistryArrays, params: EpochParams, sqrt_total: int):
    """(base reward, proposer reward) of every validator."""
    dev = reg.balance.device
    base = udiv(udiv(reg.effective_balance * params.base_reward_factor,
                     _c(sqrt_total, dev)),
                _c(params.base_rewards_per_epoch, dev))
    return base, udiv(base, _c(params.proposer_reward_quotient, dev))


def sweep_shares_plain(reg: RegistryArrays, sc: EpochScalars,
                       params: EpochParams, sums: torch.Tensor,
                       acc: torch.Tensor) -> torch.Tensor:
    """(b): each unslashed source attester's proposer share, from the
    all-reduced `sums`, added into `acc` (the n_global rows of (a)) in
    place as JAX's `.at[idx].add(mode="drop")` does: a negative index
    counts from the end of n_global, an index still outside [0, n_global)
    is dropped.  Returns the grid-wide values, a (TOTALS_WORDS,) int64
    tensor (`derive_totals`)."""
    words = derive_totals(sums, sc, params)
    _, prop = _base_reward(reg, params, words[1])
    n_global = acc.shape[0]
    idx = reg.proposer_index.to(torch.int64)
    idx = torch.where(idx < 0, idx + n_global, idx)
    keep = _flags(reg)[0] & (idx >= 0) & (idx < n_global)
    acc.index_add_(0, torch.where(keep, idx, 0),
                   torch.where(keep, prop, torch.zeros_like(prop)))
    return torch.tensor([i64(w) for w in words], dtype=torch.int64,
                        device=acc.device)


def sweep_apply_plain(reg: RegistryArrays, sc: EpochScalars,
                      params: EpochParams, totals: torch.Tensor, received):
    """(c): (new_balance, new_effective_balance) from the grid-wide
    `totals` of (b): each validator's rewards and penalties, balance +
    rewards + the proposer shares `received` - penalties with saturation,
    the proportional slashing penalty, the hysteresis."""
    p = params
    dev = reg.balance.device
    eff = reg.effective_balance
    zero = torch.zeros_like(eff)
    words = [int(w) & _MASK for w in totals.tolist()]
    total_active, sqrt_total, total_incr = words[:3]
    att_q, adj = words[3:6], words[6]
    cur, fdelay = _c(sc.current_epoch, dev), _c(sc.finality_delay, dev)
    prev = umax(cur, 1) - 1
    active_prev = ule(reg.activation_epoch, prev) & ult(prev, reg.exit_epoch)
    eligible = active_prev | (reg.slashed
                              & ult(prev + 1, reg.withdrawable_epoch))
    base, prop = _base_reward(reg, p, sqrt_total)
    in_leak = sc.finality_delay > p.min_epochs_to_inactivity_penalty

    rewards = torch.zeros_like(eff)
    penalties = torch.zeros_like(eff)
    flags = _flags(reg)
    for flag, q in zip(flags, att_q):
        comp = base if in_leak else udiv(base * _c(q, dev),
                                         _c(total_incr, dev))
        rewards += torch.where(eligible & flag, comp, zero)
        penalties += torch.where(eligible & ~flag, base, zero)
    # inclusion-delay micro-rewards
    rewards += torch.where(flags[0], udiv(base - prop,
                                          umax(reg.inclusion_delay, 1)), zero)
    if in_leak:
        leak_extra = udiv(eff * fdelay,
                          _c(p.inactivity_penalty_quotient, dev))
        penalties += torch.where(eligible, p.base_rewards_per_epoch * base
                                 - prop, zero)
        penalties += torch.where(eligible & ~flags[1], leak_extra, zero)

    is_genesis = sc.current_epoch == 0
    bal = reg.balance + (zero if is_genesis else rewards + received)
    pen = zero if is_genesis else penalties
    bal = torch.where(ult(bal, pen), zero, bal - pen)

    incr = _c(p.effective_balance_increment, dev)
    hits = reg.slashed & (
        cur + p.epochs_per_slashings_vector // 2 == reg.withdrawable_epoch)
    slash_pen = udiv(udiv(eff, incr) * _c(adj, dev),
                     _c(total_active, dev)) * incr
    slash_pen = torch.where(hits, slash_pen, zero)
    bal = torch.where(ult(bal, slash_pen), zero, bal - slash_pen)

    hyst = p.effective_balance_increment // p.hysteresis_quotient
    down = _c(hyst * p.hysteresis_downward_multiplier, dev)
    up = _c(hyst * p.hysteresis_upward_multiplier, dev)
    candidate = umin(bal - umod(bal, incr), _c(p.max_effective_balance, dev))
    move = ult(bal + down, eff) | ult(eff + up, bal)
    return bal, torch.where(move, candidate, eff)


def epoch_sweep_plain(reg: RegistryArrays, sc: EpochScalars,
                      params: EpochParams):
    """One epoch's rewards, penalties, slashings and effective-balance
    updates in plain PyTorch on the registry's device: the three phases
    on one shard.  Returns (new_balance, new_effective_balance), (N,)
    int64."""
    sums, acc = sweep_totals_plain(reg, sc, reg.balance.shape[0])
    totals = sweep_shares_plain(reg, sc, params, sums, acc)
    return sweep_apply_plain(reg, sc, params, totals, acc)


# --- kernel K1 ----------------------------------------------------------------


@functools.cache
def _lib():
    lib = _build.load("epoch_sweep")
    lib.epoch_sweep_launch.argtypes = (
        [ctypes.c_void_p] * 11 + [ctypes.c_int64]
        + [ctypes.c_void_p] * 6)
    lib.epoch_sweep_launch.restype = ctypes.c_int
    lib.epoch_sweep_scratch_bytes.argtypes = []
    lib.epoch_sweep_scratch_bytes.restype = ctypes.c_int64
    p, i64_ = ctypes.c_void_p, ctypes.c_int64
    lib.epoch_shard_scratch_bytes.argtypes = []
    lib.epoch_shard_scratch_bytes.restype = ctypes.c_int64
    lib.epoch_shard_totals_launch.argtypes = (
        [p] * 7 + [i64_, ctypes.c_uint64, p, i64_, p, p, p])
    lib.epoch_shard_shares_launch.argtypes = [p] * 4 + [i64_] * 2 + [p] * 7
    lib.epoch_shard_apply_launch.argtypes = [p] * 10 + [i64_] + [p] * 7
    lib.epoch_prelude_probe_launch.argtypes = [ctypes.c_uint64] + [p] * 4
    for f in ("epoch_shard_totals_launch", "epoch_shard_shares_launch",
              "epoch_shard_apply_launch", "epoch_prelude_probe_launch"):
        getattr(lib, f).restype = ctypes.c_int
    return lib


def _check_registry(name: str, reg: RegistryArrays) -> int:
    arrays = [getattr(reg, f) for f in RegistryArrays._fields]
    _build.require_cuda(name, *arrays)
    n = reg.balance.shape[0]
    for f, a in zip(RegistryArrays._fields, arrays):
        want = _DTYPES.get(f, torch.int64)
        if a.dtype != want or a.shape != (n,):
            raise ValueError(f"{name}: {f} must be ({n},) {want}, got "
                             f"{tuple(a.shape)} {a.dtype}")
    if n == 0:
        raise ValueError(f"{name}: empty registry")
    return n


# the params every launch divides by, once per launch through a magic
# number: none may be zero
_DIVISORS = ("base_rewards_per_epoch", "proposer_reward_quotient",
             "inactivity_penalty_quotient", "effective_balance_increment",
             "hysteresis_quotient")


def _c_params(params: EpochParams, sc: EpochScalars):
    zero = [f for f in _DIVISORS if not int(getattr(params, f))]
    if zero:
        raise ValueError(f"epoch sweep: zero divisor params {zero}")
    return ((ctypes.c_uint64 * 12)(*(int(v) for v in params)),
            (ctypes.c_uint64 * 3)(*(int(v) for v in sc)))


def epoch_sweep_kernel(reg: RegistryArrays, sc: EpochScalars,
                       params: EpochParams):
    """K1 on a registry of CUDA tensors: three launches (totals, proposer
    shares, the fused rewards and apply) and a memset of its scratch."""
    n = _check_registry("epoch_sweep", reg)
    c_params, c_scalars = _c_params(params, sc)
    dev = reg.balance.device
    lib = _lib()
    scratch = torch.empty(-(-lib.epoch_sweep_scratch_bytes() // 8),
                          dtype=torch.int64, device=dev)
    new_bal = torch.empty(n, dtype=torch.int64, device=dev)
    new_eff = torch.empty(n, dtype=torch.int64, device=dev)
    ptrs = [reg.balance, reg.effective_balance, reg.slashed,
            reg.activation_epoch, reg.exit_epoch, reg.withdrawable_epoch,
            reg.is_source, reg.is_target, reg.is_head, reg.inclusion_delay,
            reg.proposer_index]
    _build.check(lib.epoch_sweep_launch(
        *(t.data_ptr() for t in ptrs), n,
        ctypes.addressof(c_params), ctypes.addressof(c_scalars),
        scratch.data_ptr(), new_bal.data_ptr(), new_eff.data_ptr(),
        _build.stream_ptr(reg.balance)), "epoch_sweep")
    _build.launches["epoch_sweep"] += 1
    return new_bal, new_eff


def epoch_sweep(reg: RegistryArrays, sc: EpochScalars, params: EpochParams):
    """(new_balance, new_effective_balance) of one epoch transition: the
    plain version for CPU tensors, K1 for CUDA tensors."""
    if reg.balance.device.type == "cpu":
        return epoch_sweep_plain(reg, sc, params)
    return epoch_sweep_kernel(reg, sc, params)


# --- kernel K24: the sweep's three phases on one shard -----------------------

# K24's zeroed scratch (the sums' accumulators, the arrival counters) per
# (device, stream): each launch leaves it zero; a launch that raises drops
# it, so that the next call starts from a new zeroed one
_SCRATCH = {}


def _shard_scratch(dev) -> tuple:
    key = (dev, torch.cuda.current_stream(dev).cuda_stream)
    if key not in _SCRATCH:
        words = -(-_lib().epoch_shard_scratch_bytes() // 8)
        _SCRATCH[key] = torch.zeros(words, dtype=torch.int64, device=dev)
    return key, _SCRATCH[key]


def _launch_on_scratch(key, err: int) -> None:
    if err:
        _SCRATCH.pop(key, None)
    _build.check(err, "epoch_sweep_sharded")
    _build.launches["epoch_sweep_sharded"] += 1


def _check_vector(name: str, t, n: int, dev) -> None:
    if t.dtype != torch.int64 or t.shape != (n,) or t.device != dev:
        raise ValueError(f"epoch_sweep_sharded: {name} must be ({n},) int64 "
                         f"on {dev}, got {tuple(t.shape)} {t.dtype} on "
                         f"{t.device}")


def sweep_totals_kernel(reg: RegistryArrays, sc: EpochScalars,
                        n_global: int):
    """K24 (a) on a shard of CUDA tensors: (sums, acc) as
    `sweep_totals_plain` returns them, in one launch (acc is zeroed by
    the kernel, not by a memset)."""
    n = _check_registry("epoch_sweep_sharded", reg)
    if not n <= n_global < 2**31:
        raise ValueError(f"epoch_sweep_sharded: global length {n_global} "
                         f"for a shard of {n}")
    dev = reg.balance.device
    key, scratch = _shard_scratch(dev)
    sums = torch.empty(4, dtype=torch.int64, device=dev)
    acc = torch.empty(n_global, dtype=torch.int64, device=dev)
    _launch_on_scratch(key, _lib().epoch_shard_totals_launch(
        reg.effective_balance.data_ptr(), reg.slashed.data_ptr(),
        reg.activation_epoch.data_ptr(), reg.exit_epoch.data_ptr(),
        reg.is_source.data_ptr(), reg.is_target.data_ptr(),
        reg.is_head.data_ptr(), n, int(sc.current_epoch), acc.data_ptr(),
        n_global, scratch.data_ptr(), sums.data_ptr(),
        _build.stream_ptr(sums)))
    return sums, acc


def sweep_shares_kernel(reg: RegistryArrays, sc: EpochScalars,
                        params: EpochParams, sums: torch.Tensor,
                        acc: torch.Tensor) -> torch.Tensor:
    """K24 (b) on a shard of CUDA tensors: the shares added into `acc` in
    place and the (TOTALS_WORDS,) totals returned, as
    `sweep_shares_plain` does."""
    n = _check_registry("epoch_sweep_sharded", reg)
    dev = reg.balance.device
    _check_vector("sums", sums, 4, dev)
    n_global = acc.shape[0]
    if not n <= n_global < 2**31:
        raise ValueError(f"epoch_sweep_sharded: global length {n_global} "
                         f"for a shard of {n}")
    _check_vector("acc", acc, n_global, dev)
    _build.require_cuda("epoch_sweep_sharded", sums, acc)
    c_params, c_scalars = _c_params(params, sc)
    key, scratch = _shard_scratch(dev)
    totals = torch.empty(TOTALS_WORDS, dtype=torch.int64, device=dev)
    _launch_on_scratch(key, _lib().epoch_shard_shares_launch(
        reg.effective_balance.data_ptr(), reg.slashed.data_ptr(),
        reg.is_source.data_ptr(), reg.proposer_index.data_ptr(), n,
        n_global, ctypes.addressof(c_params), ctypes.addressof(c_scalars),
        sums.data_ptr(), acc.data_ptr(), scratch.data_ptr(),
        totals.data_ptr(), _build.stream_ptr(acc)))
    return totals


def sweep_apply_kernel(reg: RegistryArrays, sc: EpochScalars,
                       params: EpochParams, totals: torch.Tensor, received):
    """K24 (c) on a shard of CUDA tensors: (new_balance,
    new_effective_balance) as `sweep_apply_plain` returns them (K1's
    apply pass)."""
    n = _check_registry("epoch_sweep_sharded", reg)
    dev = reg.balance.device
    _check_vector("totals", totals, TOTALS_WORDS, dev)
    _check_vector("received", received, n, dev)
    _build.require_cuda("epoch_sweep_sharded", totals, received)
    c_params, c_scalars = _c_params(params, sc)
    new_bal = torch.empty(n, dtype=torch.int64, device=dev)
    new_eff = torch.empty(n, dtype=torch.int64, device=dev)
    ptrs = [reg.balance, reg.effective_balance, reg.slashed,
            reg.activation_epoch, reg.exit_epoch, reg.withdrawable_epoch,
            reg.is_source, reg.is_target, reg.is_head, reg.inclusion_delay]
    _build.check(_lib().epoch_shard_apply_launch(
        *(t.data_ptr() for t in ptrs), n,
        ctypes.addressof(c_params), ctypes.addressof(c_scalars),
        totals.data_ptr(), received.data_ptr(), new_bal.data_ptr(),
        new_eff.data_ptr(), _build.stream_ptr(new_bal)),
        "epoch_sweep_sharded")
    _build.launches["epoch_sweep_sharded"] += 1
    return new_bal, new_eff


def prelude_probe(total: int, sc: EpochScalars, params: EpochParams,
                  device) -> list:
    """A probe, on no path: clock64() cycles, on one warp of the card, of
    (b)'s per-block prelude (the square root and its magic), of the
    per-block derivations that the parent design's (b) and (c) ran, and
    of (b)'s last block's whole derivation, for the active balance
    `total`.  Not counted in `launches`."""
    c_params, c_scalars = _c_params(params, sc)
    out = torch.empty(5, dtype=torch.int64, device=device)
    _build.check(_lib().epoch_prelude_probe_launch(
        int(total), ctypes.addressof(c_params), ctypes.addressof(c_scalars),
        out.data_ptr(), _build.stream_ptr(out)), "epoch_prelude_probe")
    return out.tolist()[:4]


def epoch_sweep_sharded(regs, sc: EpochScalars, params: EpochParams,
                        plain: bool = False):
    """The sweep over a registry split into D contiguous shards (JAX
    `epoch_sweep(..., axis_name=...)` under `shard_map`): `regs` holds
    shard d's `RegistryArrays` on its device, every shard of one length
    n; proposer indices are global, in [0, n D).  Per shard, K24's three
    phases on CUDA tensors (their plain versions on the CPU, or with
    `plain`), with the four sums all-reduced between the first two and
    the proposer accumulators reduce-scattered between the last two.
    Returns the lists of each shard's (new_balance,
    new_effective_balance)."""
    regs = list(regs)
    n = regs[0].balance.shape[0]
    if any(r.balance.shape[0] != n for r in regs):
        raise ValueError("epoch_sweep_sharded: shards of unequal length")
    n_global = n * len(regs)

    def pick(kernel, plain_fn, reg):
        use_plain = plain or reg.balance.device.type == "cpu"
        return plain_fn if use_plain else kernel

    parts = []
    for reg in regs:
        with on(reg.balance.device):
            parts.append(pick(sweep_totals_kernel, sweep_totals_plain,
                              reg)(reg, sc, n_global))
    sums = all_reduce_sum([s for s, _ in parts])
    totals = []
    for reg, s, (_, acc) in zip(regs, sums, parts):
        with on(reg.balance.device):
            totals.append(pick(sweep_shares_kernel, sweep_shares_plain,
                               reg)(reg, sc, params, s, acc))
    received = reduce_scatter_sum([acc for _, acc in parts])
    new_bal, new_eff = [], []
    for reg, t, got in zip(regs, totals, received):
        with on(reg.balance.device):
            b, e = pick(sweep_apply_kernel, sweep_apply_plain,
                        reg)(reg, sc, params, t, got)
        new_bal.append(b)
        new_eff.append(e)
    return new_bal, new_eff
