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
from typing import NamedTuple

import torch

from .. import _build
from .._uint import i64, shr64, udiv, ule, ult, umax, umin, umod
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


def _isqrt_u64(n):
    """Exact floor sqrt of a 0-d uint64 tensor, the JAX `_isqrt_u64` step
    for step: float64 seed, a guarded Newton step, then -1/+1 fixes."""
    as_f64 = n.to(torch.float64) + torch.where(n < 0, 2.0**64, 0.0)
    x = torch.floor(torch.sqrt(as_f64)).to(torch.int64)
    newton = shr64(x + udiv(n, umax(x, 1)), 1)
    x = torch.where(x != 0, umin(x, newton), x)
    x = torch.where(ult(n, x * x), x - 1, x)
    return torch.where(ule((x + 1) * (x + 1), n), x + 1, x)


def _c(x, dev):
    """A uint64 constant as a 0-d int64 tensor on `dev`."""
    return torch.tensor(i64(x), dtype=torch.int64, device=dev)


def _flags(reg: RegistryArrays):
    unslashed = ~reg.slashed
    return [reg.is_source & unslashed, reg.is_target & unslashed,
            reg.is_head & unslashed]


def sweep_totals_plain(reg: RegistryArrays, sc: EpochScalars) -> torch.Tensor:
    """(4,) int64: the sums over the registry of the effective balances
    of the validators active this epoch, and of the unslashed source,
    target and head attesters (JAX `_total`'s local `jnp.sum`)."""
    eff = reg.effective_balance
    zero = torch.zeros_like(eff)
    cur = _c(sc.current_epoch, eff.device)
    active_cur = ule(reg.activation_epoch, cur) & ult(cur, reg.exit_epoch)
    return torch.stack([torch.where(m, eff, zero).sum()
                        for m in [active_cur] + _flags(reg)])


def _totals(sums: torch.Tensor, incr):
    """(total_active, attesting sums of the three flags) from the global
    sums, each at least one increment."""
    return umax(incr, sums[0]), [umax(incr, sums[k]) for k in (1, 2, 3)]


def sweep_deltas_plain(reg: RegistryArrays, sc: EpochScalars,
                       params: EpochParams, sums: torch.Tensor,
                       n_global: int):
    """Each validator's rewards and penalties from the global `sums`, and
    the proposers' shares scattered into a zero accumulator of
    `n_global` rows as JAX's `.at[idx].add(mode="drop")` does: a negative
    index counts from the end of `n_global`, an index still outside
    [0, n_global) is dropped.  Returns (rewards, penalties, acc)."""
    p = params
    dev = reg.balance.device
    eff = reg.effective_balance
    zero = torch.zeros_like(eff)
    cur, fdelay = _c(sc.current_epoch, dev), _c(sc.finality_delay, dev)
    prev = umax(cur, 1) - 1
    active_prev = ule(reg.activation_epoch, prev) & ult(prev, reg.exit_epoch)
    eligible = active_prev | (reg.slashed
                              & ult(prev + 1, reg.withdrawable_epoch))

    incr = _c(p.effective_balance_increment, dev)
    total_active, attesting = _totals(sums, incr)
    sqrt_total = _isqrt_u64(total_active)
    base_reward = udiv(udiv(eff * p.base_reward_factor, sqrt_total),
                       _c(p.base_rewards_per_epoch, dev))
    proposer_reward = udiv(base_reward, _c(p.proposer_reward_quotient, dev))
    in_leak = ult(_c(p.min_epochs_to_inactivity_penalty, dev), fdelay)

    rewards = torch.zeros_like(eff)
    penalties = torch.zeros_like(eff)
    flags = _flags(reg)
    for flag, att in zip(flags, attesting):
        participation = udiv(base_reward * udiv(att, incr),
                             udiv(total_active, incr))
        comp = torch.where(in_leak, base_reward, participation)
        rewards += torch.where(eligible & flag, comp, zero)
        penalties += torch.where(eligible & ~flag, base_reward, zero)

    # inclusion-delay micro-rewards, and the proposer's share scattered
    src = flags[0]
    rewards += torch.where(
        src, udiv(base_reward - proposer_reward,
                  umax(reg.inclusion_delay, 1)), zero)
    idx = reg.proposer_index.to(torch.int64)
    idx = torch.where(idx < 0, idx + n_global, idx)
    keep = src & (idx >= 0) & (idx < n_global)
    acc = torch.zeros(n_global, dtype=torch.int64, device=dev)
    acc.index_add_(0, torch.where(keep, idx, 0),
                   torch.where(keep, proposer_reward, zero))

    leak_base = p.base_rewards_per_epoch * base_reward - proposer_reward
    leak_extra = udiv(eff * fdelay, _c(p.inactivity_penalty_quotient, dev))
    penalties += torch.where(in_leak & eligible, leak_base, zero)
    penalties += torch.where(in_leak & eligible & ~flags[1], leak_extra, zero)
    return rewards, penalties, acc


def sweep_apply_plain(reg: RegistryArrays, sc: EpochScalars,
                      params: EpochParams, sums: torch.Tensor, rewards,
                      penalties, received):
    """(new_balance, new_effective_balance): balance + rewards + the
    proposer shares `received` - penalties with saturation, the
    proportional slashing penalty, the hysteresis."""
    p = params
    dev = reg.balance.device
    eff = reg.effective_balance
    zero = torch.zeros_like(eff)
    cur = _c(sc.current_epoch, dev)
    incr = _c(p.effective_balance_increment, dev)
    total_active, _ = _totals(sums, incr)

    is_genesis = sc.current_epoch == 0
    bal = reg.balance + (zero if is_genesis else rewards + received)
    pen = zero if is_genesis else penalties
    bal = torch.where(ult(bal, pen), zero, bal - pen)

    adj_slashing = umin(_c(sc.slashings_sum, dev)
                        * p.proportional_slashing_multiplier, total_active)
    hits = reg.slashed & (
        cur + p.epochs_per_slashings_vector // 2 == reg.withdrawable_epoch)
    slash_pen = udiv(udiv(eff, incr) * adj_slashing, total_active) * incr
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
    updates in plain PyTorch on the registry's device.  Returns
    (new_balance, new_effective_balance), (N,) int64."""
    sums = sweep_totals_plain(reg, sc)
    rewards, penalties, acc = sweep_deltas_plain(reg, sc, params, sums,
                                                 reg.balance.shape[0])
    return sweep_apply_plain(reg, sc, params, sums, rewards, penalties, acc)


# --- kernel K1 ----------------------------------------------------------------


@functools.cache
def _lib():
    lib = _build.load("epoch_sweep")
    lib.epoch_sweep_launch.argtypes = (
        [ctypes.c_void_p] * 11 + [ctypes.c_int64]
        + [ctypes.c_void_p] * 6)
    lib.epoch_sweep_launch.restype = ctypes.c_int
    p, i64_ = ctypes.c_void_p, ctypes.c_int64
    lib.epoch_totals_launch.argtypes = [p] * 7 + [i64_, ctypes.c_uint64, p, p]
    lib.epoch_deltas_sharded_launch.argtypes = [p] * 10 + [i64_] * 2 + [p] * 7
    lib.epoch_apply_sharded_launch.argtypes = [p] * 4 + [i64_] + [p] * 7
    for f in ("epoch_totals_launch", "epoch_deltas_sharded_launch",
              "epoch_apply_sharded_launch"):
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


def _c_params(params: EpochParams, sc: EpochScalars):
    return ((ctypes.c_uint64 * 12)(*(int(v) for v in params)),
            (ctypes.c_uint64 * 3)(*(int(v) for v in sc)))


def epoch_sweep_kernel(reg: RegistryArrays, sc: EpochScalars,
                       params: EpochParams):
    """K1 on a registry of CUDA tensors."""
    n = _check_registry("epoch_sweep", reg)
    c_params, c_scalars = _c_params(params, sc)
    dev = reg.balance.device
    sums = torch.empty(4, dtype=torch.int64, device=dev)
    new_bal = torch.empty(n, dtype=torch.int64, device=dev)
    new_eff = torch.empty(n, dtype=torch.int64, device=dev)
    ptrs = [reg.balance, reg.effective_balance, reg.slashed,
            reg.activation_epoch, reg.exit_epoch, reg.withdrawable_epoch,
            reg.is_source, reg.is_target, reg.is_head, reg.inclusion_delay,
            reg.proposer_index]
    _build.check(_lib().epoch_sweep_launch(
        *(t.data_ptr() for t in ptrs), n,
        ctypes.addressof(c_params), ctypes.addressof(c_scalars),
        sums.data_ptr(), new_bal.data_ptr(), new_eff.data_ptr(),
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


def _check_sums(name: str, sums, dev) -> None:
    if sums.dtype != torch.int64 or sums.shape != (4,) or sums.device != dev:
        raise ValueError(f"{name}: sums must be (4,) int64 on {dev}")


def sweep_totals_kernel(reg: RegistryArrays, sc: EpochScalars) -> torch.Tensor:
    """K24 (a) on a shard of CUDA tensors: its (4,) int64 sums."""
    n = _check_registry("epoch_sweep_sharded", reg)
    sums = torch.empty(4, dtype=torch.int64, device=reg.balance.device)
    _build.check(_lib().epoch_totals_launch(
        reg.effective_balance.data_ptr(), reg.slashed.data_ptr(),
        reg.activation_epoch.data_ptr(), reg.exit_epoch.data_ptr(),
        reg.is_source.data_ptr(), reg.is_target.data_ptr(),
        reg.is_head.data_ptr(), n, int(sc.current_epoch), sums.data_ptr(),
        _build.stream_ptr(sums)), "epoch_sweep_sharded")
    _build.launches["epoch_sweep_sharded"] += 1
    return sums


def sweep_deltas_kernel(reg: RegistryArrays, sc: EpochScalars,
                        params: EpochParams, sums: torch.Tensor,
                        n_global: int):
    """K24 (b) on a shard of CUDA tensors: (rewards, penalties, acc) as
    `sweep_deltas_plain` returns them."""
    n = _check_registry("epoch_sweep_sharded", reg)
    dev = reg.balance.device
    _check_sums("epoch_sweep_sharded", sums, dev)
    if not n <= n_global < 2**31:
        raise ValueError(f"epoch_sweep_sharded: global length {n_global} "
                         f"for a shard of {n}")
    c_params, c_scalars = _c_params(params, sc)
    rewards = torch.empty(n, dtype=torch.int64, device=dev)
    penalties = torch.empty(n, dtype=torch.int64, device=dev)
    acc = torch.empty(n_global, dtype=torch.int64, device=dev)
    ptrs = [reg.effective_balance, reg.slashed, reg.activation_epoch,
            reg.exit_epoch, reg.withdrawable_epoch, reg.is_source,
            reg.is_target, reg.is_head, reg.inclusion_delay,
            reg.proposer_index]
    _build.check(_lib().epoch_deltas_sharded_launch(
        *(t.data_ptr() for t in ptrs), n, n_global,
        ctypes.addressof(c_params), ctypes.addressof(c_scalars),
        sums.data_ptr(), rewards.data_ptr(), penalties.data_ptr(),
        acc.data_ptr(), _build.stream_ptr(acc)), "epoch_sweep_sharded")
    _build.launches["epoch_sweep_sharded"] += 1
    return rewards, penalties, acc


def sweep_apply_kernel(reg: RegistryArrays, sc: EpochScalars,
                       params: EpochParams, sums: torch.Tensor, rewards,
                       penalties, received):
    """K24 (c) on a shard of CUDA tensors: (new_balance,
    new_effective_balance), written over `rewards` and `penalties` (the
    buffers of (b)), which are returned."""
    n = _check_registry("epoch_sweep_sharded", reg)
    dev = reg.balance.device
    _check_sums("epoch_sweep_sharded", sums, dev)
    for t in (rewards, penalties, received):
        if t.dtype != torch.int64 or t.shape != (n,):
            raise ValueError(f"epoch_sweep_sharded: rewards, penalties and "
                             f"received must be ({n},) int64")
    _build.require_cuda("epoch_sweep_sharded", reg.balance, rewards,
                        penalties, received)
    c_params, c_scalars = _c_params(params, sc)
    _build.check(_lib().epoch_apply_sharded_launch(
        reg.balance.data_ptr(), reg.effective_balance.data_ptr(),
        reg.slashed.data_ptr(), reg.withdrawable_epoch.data_ptr(), n,
        ctypes.addressof(c_params), ctypes.addressof(c_scalars),
        sums.data_ptr(), received.data_ptr(), rewards.data_ptr(),
        penalties.data_ptr(), _build.stream_ptr(rewards)),
        "epoch_sweep_sharded")
    _build.launches["epoch_sweep_sharded"] += 1
    return rewards, penalties


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

    sums = []
    for reg in regs:
        with on(reg.balance.device):
            sums.append(pick(sweep_totals_kernel, sweep_totals_plain,
                             reg)(reg, sc))
    sums = all_reduce_sum(sums)
    deltas = []
    for reg, s in zip(regs, sums):
        with on(reg.balance.device):
            deltas.append(pick(sweep_deltas_kernel, sweep_deltas_plain,
                               reg)(reg, sc, params, s, n_global))
    received = reduce_scatter_sum([acc for _, _, acc in deltas])
    new_bal, new_eff = [], []
    for reg, s, (rew, pen, _), got in zip(regs, sums, deltas, received):
        with on(reg.balance.device):
            b, e = pick(sweep_apply_kernel, sweep_apply_plain,
                        reg)(reg, sc, params, s, rew, pen, got)
        new_bal.append(b)
        new_eff.append(e)
    return new_bal, new_eff
