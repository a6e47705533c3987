"""The epoch step (counterpart of `consensus_specs_tpu.parallel`): on one
device, the full rebuild (`make_epoch_step`) and the incremental step over
persisted Merkle forests (`IncrementalEpochStep`); over a mesh of devices
(`make_mesh`, `shard_registry`, `make_sharded_epoch_step`), the sharded
step of `partition.py`, with the collectives of `collectives.py`."""

from __future__ import annotations

import torch

from .. import resolve_device
from ..params import EpochParams
from .epoch import (EpochScalars, RegistryArrays, epoch_sweep,  # noqa: F401
                    epoch_sweep_plain)
from .bridge import (pad_pow2, participation_from_pending,  # noqa: F401
                     registry_arrays_from_state, validator_static_leaf_words)
from .collectives import (DATA_AXIS, Mesh, all_gather,  # noqa: F401
                          all_reduce_sum, reduce_scatter_sum)
from .epoch import epoch_sweep_sharded  # noqa: F401
from .incremental import (MerkleForest, SSZProof, _as_index,  # noqa: F401
                          ShardedMerkleForest, balances_forest,
                          dirty_balance_leaves, dirty_chunks_from_validators,
                          emit_proofs, merkleize_dirty, pad_dirty_idx,
                          registry_forest, roots,
                          sharded_balances_forest, update_many,
                          verify_proof)
from .merkle import (ValidatorLeaves, balances_list_root,  # noqa: F401
                     balances_list_root_sharded, pack_u64_chunks,
                     u64_leaf_words, validator_records_root,
                     validator_records_root_plain, validator_registry_root,
                     validator_registry_root_sharded)
from .partition import (EPOCH_STATE_RULES, REPLICATE, SHARD,  # noqa: F401
                        available_devices, build_mesh, epoch_state_rules,
                        epoch_step_specs, gather_tree, match_partition_rules,
                        mesh_rung, named_tree_leaves, partitioned_epoch_step,
                        shard_tree, sharded_epoch_step)


def _check_device(dev, tensors) -> None:
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"epoch step on {dev} got a tensor on "
                             f"{t.device}")


def make_epoch_step(params: EpochParams, device="cuda", plain: bool = False):
    """The flagship step on one device: the epoch sweep, then the
    balances root and the registry root of its results, as the sharded
    step (`consensus_specs_tpu.parallel.partition.sharded_epoch_step`)
    computes them.

    Returns f(reg, sc, length, leaves) -> (new_balance,
    new_effective_balance, balances_root, registry_root).  `reg` and
    `leaves` must be on `device`, padded to a power-of-two length N;
    `length` is the true validator count.  On CUDA the step runs K1, K2
    and K3; on the CPU, or with `plain`, their plain versions.  Asked for
    CUDA on a machine without a card, this raises."""
    dev = resolve_device(device)

    def step(reg: RegistryArrays, sc: EpochScalars, length: int,
             leaves: ValidatorLeaves):
        _check_device(dev, (*reg, *leaves))
        if plain:
            new_bal, new_eff = epoch_sweep_plain(reg, sc, params)
            records = validator_records_root_plain
        else:
            new_bal, new_eff = epoch_sweep(reg, sc, params)
            records = validator_records_root
        bal_root = balances_list_root(new_bal, length, plain=plain)
        rec = records(leaves, new_eff, reg.slashed,
                      reg.activation_eligibility_epoch, reg.activation_epoch,
                      reg.exit_epoch, reg.withdrawable_epoch, length)
        reg_root = validator_registry_root(rec, length, plain=plain)
        return new_bal, new_eff, bal_root, reg_root

    return step


def make_mesh(n_devices: int | None = None, axis: str = DATA_AXIS,
              devices=None) -> Mesh:
    """A one-axis mesh of a power-of-two width (`partition.build_mesh`):
    the first `n_devices` cards, or the explicit `devices`."""
    return build_mesh(n_devices=n_devices, axis=axis, devices=devices,
                      require_pow2=True)


def shard_registry(mesh: Mesh, reg: RegistryArrays) -> list:
    """Each shard's `RegistryArrays` on its device, the placements from the
    rule table."""
    return shard_tree(mesh, reg, EPOCH_STATE_RULES)


def make_sharded_epoch_step(mesh: Mesh, params: EpochParams):
    """The sharded full step (`partition.sharded_epoch_step`): step(reg
    shards, sc, length, pubkey_root shards, credentials shards) ->
    (new_bal shards, new_eff shards, balances_root per shard,
    registry_root per shard), equal bit for bit to `make_epoch_step`'s
    outputs over the concatenated registry."""
    return sharded_epoch_step(mesh, params)


class IncrementalEpochStep:
    """The epoch step as `bench.py`'s epoch worker runs it: the sweep's
    new balances and effective balances apply to a fixed dirty set of
    validators only, and two persisted forests (`MerkleForest`) re-hash
    only the dirty root-to-leaf paths.

    Construction builds both forests in full from `reg` (N validators,
    the list length N): the balances forest (K5 for the leaf level, K2)
    and the registry forest over every record root (K3, K2).  Each call
    then runs the masked sweep (K1 and `torch.where`), gathers the dirty
    balance chunks (K5) and the dirty record roots (K3's gather mode),
    updates both forests in one K4 launch and reads both data roots to
    the host in one copy, returning (new_balance, new_effective_balance,
    balances_root, registry_root), the roots as (8,) int32 words on the
    CPU.  `reg` itself is not changed, so every call computes the same
    step.  On CUDA this runs the kernels; on the
    CPU, or with `plain`, their plain versions."""

    def __init__(self, params: EpochParams, reg: RegistryArrays,
                 sc: EpochScalars, leaves: ValidatorLeaves,
                 dirty_validators, device="cuda", plain: bool = False):
        dev = resolve_device(device)
        _check_device(dev, (*reg, *leaves))
        n = reg.balance.shape[0]
        self.params, self.reg, self.sc, self.leaves = params, reg, sc, leaves
        self.plain = plain
        self.balances_forest = balances_forest(reg.balance, n, device=dev,
                                               plain=plain)
        self.registry_forest = registry_forest(
            self._records(reg.effective_balance), n, device=dev, plain=plain)
        dirty = torch.unique(_as_index(dirty_validators).cpu())
        if dirty.numel() and not 0 <= int(dirty[0]) <= int(dirty[-1]) < n:
            raise ValueError(f"dirty validator indices must lie in [0, {n})")
        self.chunk_idx = pad_dirty_idx(dirty_chunks_from_validators(dirty),
                                       self.balances_forest.capacity).to(dev)
        self.validator_idx = pad_dirty_idx(
            dirty, self.registry_forest.capacity).to(dev)
        self.mask = torch.zeros(n, dtype=torch.bool, device=dev)
        self.mask[dirty.to(dev)] = True

    def _records(self, effective_balance, index=None):
        reg = self.reg
        records = (validator_records_root_plain if self.plain
                   else validator_records_root)
        return records(self.leaves, effective_balance, reg.slashed,
                       reg.activation_eligibility_epoch, reg.activation_epoch,
                       reg.exit_epoch, reg.withdrawable_epoch, index=index)

    def __call__(self):
        reg = self.reg
        sweep = epoch_sweep_plain if self.plain else epoch_sweep
        new_bal, new_eff = sweep(reg, self.sc, self.params)
        new_bal = torch.where(self.mask, new_bal, reg.balance)
        new_eff = torch.where(self.mask, new_eff, reg.effective_balance)
        bal_leaves = dirty_balance_leaves(new_bal, self.chunk_idx,
                                          plain=self.plain)
        rec = self._records(new_eff, index=self.validator_idx)
        forests = (self.balances_forest, self.registry_forest)
        update_many(zip(forests, (self.chunk_idx, self.validator_idx),
                        (bal_leaves, rec)))
        bal_root, reg_root = roots(forests)
        return new_bal, new_eff, bal_root, reg_root
