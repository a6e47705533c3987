"""From a spec `BeaconState` to the sweep's struct-of-arrays registry, on
the host (counterpart of `consensus_specs_tpu.parallel.bridge`).

The spec module and the state are arguments (duck-typed: any phase0
spec made by the JAX package's `build_spec`, or another with the same
functions), so the port imports nothing of the JAX package.  The
committee expansion of the previous epoch's PendingAttestations into
per-validator flags is the only O(attestations x committee) host loop,
once per epoch.  The results are CPU tensors in the port's layout
(uint64 as int64 bit patterns, words as int32), ready for `shard_tree`
or `.to(device)`.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from .._uint import from_numpy_u32, from_numpy_u64
from .epoch import EpochScalars, RegistryArrays


def participation_from_pending(spec, state):
    """Previous-epoch PendingAttestations expanded into per-validator
    source, target and head flags, the minimum inclusion delay (1 where
    none) and the proposer of that attestation (0 where none), as numpy
    arrays (JAX `:18`: the matching rules of
    `get_unslashed_attesting_indices` and `get_inclusion_delay_deltas`)."""
    n = len(state.validators)
    is_source = np.zeros(n, dtype=bool)
    is_target = np.zeros(n, dtype=bool)
    is_head = np.zeros(n, dtype=bool)
    inclusion_delay = np.full(n, np.iinfo(np.uint64).max, dtype=np.uint64)
    proposer = np.zeros(n, dtype=np.int32)

    prev = spec.get_previous_epoch(state)
    atts = spec.get_matching_source_attestations(state, prev)
    target_root = spec.get_block_root(state, prev)
    for a in atts:
        indices = list(spec.get_attesting_indices(state, a))
        matching_target = a.data.target.root == target_root
        matching_head = (
            matching_target
            and a.data.beacon_block_root
            == spec.get_block_root_at_slot(state, a.data.slot))
        for i in indices:
            i = int(i)
            is_source[i] = True
            if matching_target:
                is_target[i] = True
            if matching_head:
                is_head[i] = True
            if int(a.inclusion_delay) < int(inclusion_delay[i]):
                inclusion_delay[i] = int(a.inclusion_delay)
                proposer[i] = int(a.proposer_index)
    inclusion_delay[~is_source] = 1
    return is_source, is_target, is_head, inclusion_delay, proposer


def registry_arrays_from_state(spec, state) -> tuple:
    """(RegistryArrays of CPU tensors, EpochScalars) of a BeaconState
    before its epoch processing (JAX `:55`)."""
    n = len(state.validators)
    vals = state.validators

    def u64(values):
        return from_numpy_u64(np.fromiter(values, np.uint64, n), "cpu")

    src, tgt, head, delay, prop = participation_from_pending(spec, state)
    reg = RegistryArrays(
        balance=u64(int(b) for b in state.balances),
        effective_balance=u64(int(v.effective_balance) for v in vals),
        slashed=torch.from_numpy(
            np.fromiter((bool(v.slashed) for v in vals), bool, n)),
        activation_eligibility_epoch=u64(
            int(v.activation_eligibility_epoch) for v in vals),
        activation_epoch=u64(int(v.activation_epoch) for v in vals),
        exit_epoch=u64(int(v.exit_epoch) for v in vals),
        withdrawable_epoch=u64(int(v.withdrawable_epoch) for v in vals),
        is_source=torch.from_numpy(src), is_target=torch.from_numpy(tgt),
        is_head=torch.from_numpy(head),
        inclusion_delay=from_numpy_u64(delay, "cpu"),
        proposer_index=torch.from_numpy(prop))
    cur = int(spec.get_current_epoch(state))
    prev = int(spec.get_previous_epoch(state))
    sc = EpochScalars(
        current_epoch=cur,
        finality_delay=prev - int(state.finalized_checkpoint.epoch),
        slashings_sum=sum(int(s) for s in state.slashings) % 2**64)
    return reg, sc


def pad_pow2(arr, multiple_of: int = 1):
    """Pad (N, ...) rows (a tensor or a numpy array) with zeros to the next
    power-of-two length that is also a multiple of `multiple_of` (a shard
    count, itself a power of two)."""
    if multiple_of < 1 or multiple_of & (multiple_of - 1):
        raise ValueError("the shard count must be a power of two")
    n = arr.shape[0]
    target = 1
    while target < max(n, multiple_of):
        target *= 2
    if target == n:
        return arr
    if isinstance(arr, torch.Tensor):
        return torch.cat([arr, arr.new_zeros((target - n,) + arr.shape[1:])])
    pad = np.zeros((target - n,) + arr.shape[1:], dtype=arr.dtype)
    return np.concatenate([arr, pad])


def validator_static_leaf_words(spec, state):
    """The static leaves of each validator record, (N, 8) int32 word
    tensors on the CPU: the pubkey's root (SHA-256 of the 48 bytes padded
    to 64) and the withdrawal credentials (JAX `:107`)."""
    del spec
    n = len(state.validators)
    pk = np.zeros((n, 32), dtype=np.uint8)
    cred = np.zeros((n, 32), dtype=np.uint8)
    for i, v in enumerate(state.validators):
        pk[i] = np.frombuffer(
            hashlib.sha256(bytes(v.pubkey) + bytes(16)).digest(), np.uint8)
        cred[i] = np.frombuffer(bytes(v.withdrawal_credentials), np.uint8)

    def words(b):
        return from_numpy_u32(b.view(">u4").astype(np.uint32), "cpu")

    return words(pk), words(cred)
