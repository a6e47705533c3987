"""The partition-rule registry, the mesh and the sharded epoch step
(counterpart of `consensus_specs_tpu.parallel.partition`).

- `match_partition_rules(rules, tree)` maps every path-named leaf of a
  tree (NamedTuples and dicts by field name, lists and tuples by
  position) to `SHARD` or `REPLICATE`: scalar leaves never shard, the
  FIRST rule whose regex matches the `/`-joined path wins, and a
  non-scalar leaf that no rule matches raises `ValueError`.  The markers
  take the place of JAX's `PartitionSpec`s.
- `build_mesh` is the one way to make a mesh: the first `n_devices` CUDA
  devices, an explicit `device_ids` subset, or an explicit `devices`
  list, which may repeat a device (a virtual mesh: the counterpart of
  JAX's forced host devices, used by the tests and `chip_smoke.py`).
  Without a CUDA device and without `devices`, it raises.
- `shard_tree` splits every `SHARD` leaf of a tree into D contiguous
  row blocks, each copied to its shard's device, and copies every
  `REPLICATE` tensor to each device: it returns the list of the D
  shards' trees.  `gather_tree` concatenates them back on the host.
- `sharded_epoch_step` is the flagship step over the mesh: K24 with its
  collectives, then the sharded balances and registry roots; which of
  its arguments are per-shard lists comes from the rule table
  (`epoch_step_specs`).  `partitioned_epoch_step` caches one step per
  (params, topology).
"""

from __future__ import annotations

import functools
import re

import torch

from ..params import EpochParams
from .collectives import DATA_AXIS, Mesh, on
from .epoch import EpochScalars, RegistryArrays, epoch_sweep_sharded
from .merkle import (ValidatorLeaves, balances_list_root_sharded,
                     shard_length, validator_records_root,
                     validator_registry_root_sharded)

SHARD = "shard"
REPLICATE = "replicate"


# --- rule matching -----------------------------------------------------------


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _map_tree(fn, tree, sep: str = "/"):
    """The tree with every leaf replaced by fn(path, leaf), in the order
    `named_tree_leaves` lists them."""

    def walk(prefix, node):
        if _is_namedtuple(node):
            return type(node)(*(walk(prefix + [f], s)
                                for f, s in zip(node._fields, node)))
        if isinstance(node, dict):
            return {k: walk(prefix + [str(k)], v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            vals = [walk(prefix + [str(i)], s) for i, s in enumerate(node)]
            return vals if isinstance(node, list) else tuple(vals)
        return fn(sep.join(prefix), node)

    return walk([], tree)


def named_tree_leaves(tree, sep: str = "/") -> list:
    """[(path, leaf)] pairs: NamedTuple fields and dict keys by name,
    list and tuple positions by index."""
    out = []
    _map_tree(lambda name, leaf: out.append((name, leaf)), tree, sep)
    return out


def _leaf_is_scalar(leaf) -> bool:
    shape = tuple(getattr(leaf, "shape", ()))
    n = 1
    for s in shape:
        n *= int(s)
    return len(shape) == 0 or n == 1


def _spec_for(rules, name: str, leaf) -> str:
    if _leaf_is_scalar(leaf):
        return REPLICATE
    for rule, spec in rules:
        if re.search(rule, name) is not None:
            return spec
    raise ValueError(
        f"no partition rule matches leaf {name!r} "
        f"(shape {tuple(getattr(leaf, 'shape', ()))}): add a row to the "
        f"rule table")


def match_partition_rules(rules, tree, sep: str = "/"):
    """The tree of `SHARD` / `REPLICATE` markers for `tree` under `rules`,
    an ordered sequence of (regex, marker) pairs."""
    return _map_tree(lambda name, leaf: _spec_for(rules, name, leaf), tree,
                     sep)


def epoch_state_rules():
    """The rule table of the flagship epoch state (JAX `:130`): every
    validator-indexed array shards over the mesh, the per-epoch scalars
    replicate."""
    return (
        (r"(^|/)(balance|effective_balance|slashed"
         r"|activation_eligibility_epoch|activation_epoch|exit_epoch"
         r"|withdrawable_epoch|is_source|is_target|is_head"
         r"|inclusion_delay|proposer_index)$", SHARD),
        (r"(^|/)(pubkey_root|credentials|record_roots|leaf_words"
         r"|balances)$", SHARD),
        (r"(^|/)(mask|sweep_mask|dirty_mask|dirty_idx|chunk_idx)$", SHARD),
        (r"(^|/)(current_epoch|finality_delay|slashings_sum|length)$",
         REPLICATE),
    )


EPOCH_STATE_RULES = epoch_state_rules()


# --- mesh building -----------------------------------------------------------


def mesh_rung(n: int) -> int:
    """Largest power of two <= n: the mesh-width ladder."""
    if n < 1:
        raise ValueError(f"mesh_rung({n})")
    return 1 << (int(n).bit_length() - 1)


def available_devices() -> int:
    """The number of CUDA devices (0 without a card)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    if d.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {d}")
    return d


def build_mesh(n_devices: int | None = None, axis: str = DATA_AXIS,
               device_ids=None, require_pow2: bool = False,
               devices=None) -> Mesh:
    """The one-axis mesh every sharded path uses.  `devices` (torch
    devices, which may repeat) is the mesh as given; otherwise
    `device_ids` (CUDA device indices) builds it from exactly those
    cards, and else the first
    `n_devices` cards (all, when None).  Without a CUDA device and without
    `devices`, this raises.  `require_pow2` requires a power-of-two width
    (the sharded list roots need it; quantize with `mesh_rung`)."""
    if devices is not None:
        devs = [_device(d) for d in devices]
        if not devs:
            raise ValueError("build_mesh: an empty device list")
    else:
        count = available_devices()
        if count == 0:
            raise RuntimeError("build_mesh: no CUDA device is available "
                               "(pass devices=... for an explicit mesh)")
        if device_ids is not None:
            ids = tuple(int(i) for i in device_ids)
            if not ids or min(ids) < 0 or max(ids) >= count:
                raise ValueError(f"build_mesh: device ids {ids} of {count}")
            devs = [torch.device("cuda", i) for i in ids]
        else:
            n = count if n_devices is None else int(n_devices)
            if not 1 <= n <= count:
                raise ValueError(f"build_mesh: {n} devices of {count}")
            devs = [torch.device("cuda", i) for i in range(n)]
    n = len(devs)
    if require_pow2 and n & (n - 1):
        raise ValueError(f"the mesh must be a power of two for the sharded "
                         f"merkle reduction, got {n} devices (quantize "
                         f"with mesh_rung)")
    return Mesh(tuple(devs), axis)


# --- shard / gather ----------------------------------------------------------


def _piece(leaf, spec: str, d: int, size: int, device):
    if not isinstance(leaf, torch.Tensor):
        if not _leaf_is_scalar(leaf):
            raise TypeError(f"shard_tree places tensors and host scalars, "
                            f"got {type(leaf).__name__}")
        return leaf                      # a host scalar, replicated as is
    if spec == REPLICATE:
        return leaf.to(device, copy=True)
    rows = leaf.shape[0]
    if rows % size:
        raise ValueError(f"{rows} rows do not split over {size} shards")
    n = rows // size
    return leaf[d * n:(d + 1) * n].to(device, copy=True).contiguous()


def shard_tree(mesh: Mesh, tree, rules=EPOCH_STATE_RULES) -> list:
    """The D shards' trees: `SHARD` tensors split into D contiguous row
    blocks, shard d's copied to `mesh.devices[d]`; `REPLICATE` tensors
    copied to every device; host scalars as they are.  Every shard's
    tensors are copies, never views of `tree` or of each other."""
    out = []
    for d, dev in enumerate(mesh.devices):
        with on(dev):
            out.append(_map_tree(
                lambda name, leaf: _piece(leaf, _spec_for(rules, name, leaf),
                                          d, mesh.size, dev), tree))
    return out


def gather_tree(shards, rules=EPOCH_STATE_RULES):
    """The tree back on the host: `SHARD` leaves concatenated over the
    shards, `REPLICATE` leaves from shard 0, as CPU tensors."""
    flat = [[leaf for _, leaf in named_tree_leaves(s)] for s in shards]
    pos = iter(range(len(flat[0])))

    def join(name, leaf):
        i = next(pos)
        if not isinstance(leaf, torch.Tensor):
            return leaf
        if _spec_for(rules, name, leaf) == REPLICATE:
            return leaf.cpu()
        return torch.cat([f[i].cpu() for f in flat])

    return _map_tree(join, shards[0])


# --- the sharded epoch step --------------------------------------------------


def epoch_step_specs():
    """(in_specs, out_specs) of the flagship step, derived from the rule
    table: f(reg: RegistryArrays, sc: EpochScalars, length, pubkey_root,
    credentials) -> (new_bal, new_eff, balances_root, registry_root)."""
    rules = epoch_state_rules()
    dummy = torch.zeros(2, dtype=torch.int64)
    reg_specs = match_partition_rules(
        rules, RegistryArrays(*([dummy] * len(RegistryArrays._fields))))
    sc_specs = match_partition_rules(
        rules, EpochScalars(*([0] * len(EpochScalars._fields))))
    leaf_specs = match_partition_rules(
        rules, {"pubkey_root": torch.zeros((2, 8), dtype=torch.int32),
                "credentials": torch.zeros((2, 8), dtype=torch.int32)})
    in_specs = (reg_specs, sc_specs, REPLICATE, leaf_specs["pubkey_root"],
                leaf_specs["credentials"])
    out_specs = (SHARD, SHARD, REPLICATE, REPLICATE)
    return in_specs, out_specs


def _has_shard(spec) -> bool:
    return any(s == SHARD for _, s in named_tree_leaves(spec))


def _check_placed(mesh: Mesh, shards) -> None:
    """`shards` is one tree per mesh device, its tensors on that device."""
    if not isinstance(shards, (list, tuple)) or len(shards) != mesh.size:
        raise ValueError(f"expected a list of {mesh.size} shards")
    for dev, shard in zip(mesh.devices, shards):
        for name, leaf in named_tree_leaves(shard):
            if isinstance(leaf, torch.Tensor) and leaf.device != dev:
                raise ValueError(f"shard leaf {name!r} on {leaf.device}, "
                                 f"its shard's device is {dev}")


def sharded_epoch_step(mesh: Mesh, params: EpochParams):
    """The flagship step over `mesh` (JAX `:248`): the sweep with
    all-reduced totals and the cross-shard proposer scatter (K24), the
    sharded balances root, each shard's record roots (K3) and the sharded
    registry root (K2 per level).

    Returns step(reg, sc, length, pubkey_root, credentials) ->
    (new_bal, new_eff, balances_root, registry_root), where the arguments
    the rule table shards (`reg`, `pubkey_root`, `credentials`) are lists
    of the D shards' values (`shard_tree`), the N rows split evenly, N a
    power of two and N / D a multiple of 4; `length` is the true
    validator count.  new_bal and new_eff come back as each shard's
    (N / D,) tensor, the two roots once per shard, (8,) on its device.
    On CUDA the step runs the kernels; on the CPU their plain
    versions."""
    in_specs, _ = epoch_step_specs()

    def step(reg, sc: EpochScalars, length: int, pubkey_root, credentials):
        args = (reg, sc, length, pubkey_root, credentials)
        for arg, spec in zip(args, in_specs):
            if _has_shard(spec):
                _check_placed(mesh, arg)
        new_bal, new_eff = epoch_sweep_sharded(reg, sc, params)
        bal_roots = balances_list_root_sharded(new_bal, length)
        n_local = new_eff[0].shape[0]
        rec = []
        for d, r in enumerate(reg):
            with on(mesh.devices[d]):
                rec.append(validator_records_root(
                    ValidatorLeaves(pubkey_root[d], credentials[d]),
                    new_eff[d], r.slashed, r.activation_eligibility_epoch,
                    r.activation_epoch, r.exit_epoch, r.withdrawable_epoch,
                    shard_length(length, d, n_local)))
        reg_roots = validator_registry_root_sharded(rec, length)
        return new_bal, new_eff, bal_roots, reg_roots

    return step


@functools.lru_cache(maxsize=16)
def _partitioned_epoch_step_cached(params, n_devices, device_ids, devices):
    mesh = build_mesh(n_devices=n_devices, device_ids=device_ids,
                      devices=devices, require_pow2=True)
    return sharded_epoch_step(mesh, params)


def partitioned_epoch_step(params: EpochParams, n_devices: int | None = None,
                           device_ids=None, devices=None):
    """`sharded_epoch_step` keyed by mesh topology: the first `n_devices`
    cards (all, when None), an explicit `device_ids` subset, or an
    explicit `devices` list.  One cached step per (params, topology)."""
    if device_ids is not None:
        device_ids = tuple(int(i) for i in device_ids)
    if devices is not None:
        devices = tuple(_device(d) for d in devices)
    return _partitioned_epoch_step_cached(params, n_devices, device_ids,
                                          devices)
