"""Carry the JAX side's inputs and outputs across, as numpy arrays.

uint64 arrays become int64 tensors and uint32 words int32 tensors with the
same bits (`_uint`), so both packages see the same state.  The registry
and leaves are this system's "weights": the tests and `chip_smoke.py`
make them with numpy and hand them to both sides through this module.
"""

from __future__ import annotations

import numpy as np
import torch

from . import resolve_device
from ._uint import from_numpy_u32, from_numpy_u64, to_numpy_u32, to_numpy_u64
from .parallel.epoch import EpochScalars, RegistryArrays
from .parallel.merkle import ValidatorLeaves

_BOOL = ("slashed", "is_source", "is_target", "is_head")


def registry_to_torch(reg, device="cuda") -> RegistryArrays:
    """A numpy registry (any NamedTuple or mapping with the
    `RegistryArrays` fields: uint64, bool and int32 arrays) -> the port's
    `RegistryArrays` on `device`."""
    dev = resolve_device(device)
    get = reg.get if isinstance(reg, dict) else (lambda f: getattr(reg, f))
    out = {}
    for f in RegistryArrays._fields:
        a = np.asarray(get(f))
        if f in _BOOL:
            out[f] = torch.from_numpy(a.astype(bool)).to(dev)
        elif f == "proposer_index":
            out[f] = torch.from_numpy(a.astype(np.int32)).to(dev)
        else:
            out[f] = from_numpy_u64(a, dev)
    return RegistryArrays(**out)


def scalars_to_torch(sc) -> EpochScalars:
    """JAX-side `EpochScalars` (uint64 scalars) -> the port's ints."""
    return EpochScalars(*(int(np.uint64(v)) for v in sc))


def leaves_to_torch(pubkey_root, credentials, device="cuda") -> ValidatorLeaves:
    """(N, 8) uint32 pubkey-root and credential words -> ValidatorLeaves."""
    dev = resolve_device(device)
    return ValidatorLeaves(from_numpy_u32(pubkey_root, dev),
                           from_numpy_u32(credentials, dev))


# the reverse, for the outputs: int64 balances -> numpy uint64, int32
# words (roots, digests) -> numpy uint32
u64_to_numpy = to_numpy_u64
words_to_numpy = to_numpy_u32


def synthetic_registry(n: int, seed: int = 0) -> dict:
    """A mainnet-like registry of `n` validators as numpy arrays, the
    recipe of the flagship entry point (`__graft_entry__.py`
    `_synthetic_registry`): balances around 32 ETH, 0.1% slashed, 99/98/95%
    source/target/head participation, exits at FAR_FUTURE_EPOCH."""
    rng = np.random.RandomState(seed)
    far = np.uint64(2**64 - 1)
    return dict(
        balance=rng.randint(
            31_000_000_000, 33_000_000_000, n).astype(np.uint64),
        effective_balance=np.full(n, 32_000_000_000, np.uint64),
        slashed=rng.rand(n) < 0.001,
        activation_eligibility_epoch=np.zeros(n, np.uint64),
        activation_epoch=np.zeros(n, np.uint64),
        exit_epoch=np.full(n, far, np.uint64),
        withdrawable_epoch=np.full(n, far, np.uint64),
        is_source=rng.rand(n) < 0.99,
        is_target=rng.rand(n) < 0.98,
        is_head=rng.rand(n) < 0.95,
        inclusion_delay=rng.randint(1, 5, n).astype(np.uint64),
        proposer_index=rng.randint(0, n, n).astype(np.int32),
    )


def hot_proposers(n: int, count: int = 32, seed: int = 0) -> np.ndarray:
    """(n,) int32 proposer indices drawn from `count` of n validators: a
    phase0 mainnet epoch's attesters name at most 64 proposers (one a slot
    of the two epochs whose blocks include their attestations), so the
    proposer shares pile onto few rows."""
    rng = np.random.RandomState(seed + 17)
    hot = rng.choice(n, count, replace=False)
    return hot[rng.randint(0, count, n)].astype(np.int32)


def edge_registry(n: int, seed: int = 0, single_active: bool = False,
                  current_epoch: int = 100,
                  epochs_per_slashings_vector: int = 8192,
                  increment: int = 10**9) -> dict:
    """`synthetic_registry(n, seed)` with the uint64 edges of the sweep's
    divisions and saturations: effective balances 0, 1, increment - 1 and
    2**64 - 1, inclusion delays 0, 1 and 2**64 - 1, balances 0 and
    2**64 - 1, slashed validators at `current_epoch`'s slashing epoch,
    proposers past the registry and negative.  With `single_active`, one
    validator (the last) is active: the totals are one increment."""
    reg = synthetic_registry(n, seed)
    top = np.uint64(2**64 - 1)
    eff, delay, bal = (reg["effective_balance"], reg["inclusion_delay"],
                       reg["balance"])
    eff[::7], eff[1::7], eff[2::7], eff[3::11] = 0, 1, increment - 1, top
    delay[::5], delay[1::5], delay[2::5] = 0, 1, top
    bal[::13], bal[1::13] = 0, top
    reg["slashed"][::17] = True
    reg["withdrawable_epoch"][::17] = (current_epoch
                                       + epochs_per_slashings_vector // 2)
    reg["proposer_index"][::19] = n + 5
    reg["proposer_index"][1::19] = -2
    if single_active:
        reg["activation_epoch"][:-1] = top
    return reg


def synthetic_leaf_words(n: int, seed: int = 2):
    """Random (n, 8) uint32 pubkey-root and credential words, the recipe
    of `__graft_entry__.py` `dryrun_multichip`."""
    rng = np.random.RandomState(seed)
    pk_root = rng.randint(0, 2**32, (n, 8), dtype=np.uint64).astype(np.uint32)
    cred = rng.randint(0, 2**32, (n, 8), dtype=np.uint64).astype(np.uint32)
    return pk_root, cred


def incremental_step_inputs(n: int, dirty_frac: float = 0.01, seed: int = 7):
    """The incremental step's other inputs, the recipe of `bench.py`
    `worker_epoch`: from one `RandomState(seed)`, random (n, 8) uint32
    pubkey-root and credential words, then the sorted dirty validator
    set of max(1, int(dirty_frac * n)) distinct indices."""
    rng = np.random.RandomState(seed)
    pk_root = rng.randint(0, 2**32, (n, 8), dtype=np.uint64).astype(np.uint32)
    cred = rng.randint(0, 2**32, (n, 8), dtype=np.uint64).astype(np.uint32)
    m = max(1, int(dirty_frac * n))
    dirty = np.sort(rng.choice(n, m, replace=False)).astype(np.int64)
    return pk_root, cred, dirty


def rlc_inputs(tasks, rng, device="cuda", device_h2c=False):
    """The RLC batch's inputs, the arrays of the JAX package's
    `_prepare_rlc_inputs` (padded to `_bucket(n_live)`) as the port's
    tensors on `device`: (pk_x, pk_y, sig_x, sig_y, h_x, h_y, r_bits,
    mask), limbs int32, mask bool; under `device_h2c`, one (B, 8) int32
    message-word tensor in place of (h_x, h_y).  The coefficients come
    from `rng` in JAX's order ([1] + [getrandbits(128) | 1 ...]), so one
    seeded `random.Random` gives both packages the same inputs.  Returns
    (tensors, n_live), or (None, verdict) where no batch is needed
    (`ops.bls_batch._prepare_rlc_inputs`, which then checks each task
    with `pairing_check_device` on `device`)."""
    from .ops.bls_batch import _prepare_rlc_inputs, _to

    dev = resolve_device(device)
    arrays, n = _prepare_rlc_inputs(tasks, rng, device_h2c, dev)
    if arrays is None:
        return None, n
    return tuple(_to(a, dev) for a in arrays), n


# --- the scalar field (Fr) and the KZG / DAS inputs -------------------------


def fr_limbs_to_torch(limbs, device="cuda") -> torch.Tensor:
    """JAX `FR` limbs (numpy int32 (..., 33), Montgomery R = 2**396) ->
    the port's tensor on `device`, the same limbs."""
    from .ops.fr_batch import N_LIMBS

    a = np.ascontiguousarray(np.asarray(limbs), dtype=np.int32)
    assert a.shape[-1] == N_LIMBS
    return torch.from_numpy(a).to(resolve_device(device))


def fr_ints_to_torch(xs, device="cuda") -> torch.Tensor:
    """Canonical ints -> (n, 33) Montgomery limbs on `device` (JAX
    `FR.to_mont_batch`'s limbs)."""
    from .ops.fr_batch import FR

    return fr_limbs_to_torch(FR.to_mont_batch([int(x) for x in xs]), device)


def g1_limbs_to_torch(x, y, z, device="cuda"):
    """JAX Jacobian G1 limb stacks (numpy int32 (..., 33) each, Fq
    Montgomery R = 2**396, infinity Z = 0; e.g. JAX's
    `_fk20_setup_tables()`) -> the port's (x, y, z) tensors on `device`,
    the same limbs."""
    dev = resolve_device(device)
    out = []
    for c in (x, y, z):
        a = np.ascontiguousarray(np.asarray(c), dtype=np.int32)
        assert a.shape[-1] == 33
        out.append(torch.from_numpy(a).to(dev))
    return tuple(out)


def kzg_blobs(n: int = 6) -> list[bytes]:
    """Config #5's blobs, the recipe of `bench.py:1112 worker_kzg`: field
    element j of blob i is (2 + i)^(j + 256) mod r, 4096 elements of 32
    big-endian bytes."""
    from .ops.fr_batch import R_MODULUS

    return [b"".join(int.to_bytes(pow(2 + i, j + 256, R_MODULUS), 32, "big")
                     for j in range(4096)) for i in range(n)]


def closed_form_blob(c2: int = 90001, c1: int = 80001, c0: int = 70001):
    """The degree-65 blob f = c2 X^65 + c1 X^64 + c0 of `bench.py:771-794`
    with its 128 cells and proofs in closed form: (blob, cells, proofs,
    commitment)."""
    from .das import ciphersuite as cs

    m = cs.FIELD_ELEMENTS_PER_BLOB
    p = cs.BLS_MODULUS
    roots = cs.roots_of_unity(m)
    evals = []
    for i in range(m):
        x = roots[cs.reverse_bits(i, m)]
        evals.append((c2 * pow(x, 65, p) + c1 * pow(x, 64, p) + c0) % p)
    commitment, per_cell = cs.closed_form_row(
        c2, c1, c0, range(cs.CELLS_PER_EXT_BLOB))
    cells = [per_cell[k][0] for k in range(cs.CELLS_PER_EXT_BLOB)]
    proofs = [per_cell[k][1] for k in range(cs.CELLS_PER_EXT_BLOB)]
    return cs._encode_evals(evals), cells, proofs, commitment


def proto_store_from_mirror(src, device="cuda"):
    """A port `ProtoArrayStore` on `device` in the same state as `src`,
    any object with the JAX store's host mirror: the block lists (`roots`,
    `parent`, `slots`, `je`, `uje`, `_fin_ok`), the validator arrays
    (`_eb`, `_active`, `_slashed`, `_equiv`, `_lm_epoch`, `_lm_block`),
    the checkpoints, the clock, the boost root and the constructor's
    constants.  `src._sync_pending()` runs first, so batches `src`
    applied on its device are in the mirror."""
    from .forkchoice import ProtoArrayStore

    src._sync_pending()
    dst = ProtoArrayStore(
        src.roots[0], src.slots[0], justified_epoch=src.justified_epoch,
        finalized_epoch=src.finalized_epoch,
        slots_per_epoch=src.slots_per_epoch,
        proposer_boost_pct=src.proposer_boost_pct,
        effective_balance_increment=src.effective_balance_increment,
        preset=src.preset, device=device)
    dst.roots = [bytes(r) for r in src.roots]
    dst.root_index = {r: i for i, r in enumerate(dst.roots)}
    for name in ("parent", "slots", "je", "uje"):
        setattr(dst, name, [int(x) for x in getattr(src, name)])
    dst._fin_ok = [bool(x) for x in src._fin_ok]
    for name in ("_eb", "_active", "_slashed", "_equiv", "_lm_epoch",
                 "_lm_block"):
        setattr(dst, name, np.array(getattr(src, name), copy=True))
    dst.justified_root = bytes(src.justified_root)
    dst.finalized_root = bytes(src.finalized_root)
    dst.current_epoch = int(src.current_epoch)
    dst.set_proposer_boost(src.proposer_boost_root)
    return dst


# --- the sharded path --------------------------------------------------------


def sharded_step_inputs(reg, pubkey_root, credentials, mesh):
    """The JAX side's sharded-step inputs (the bridge's numpy registry,
    any NamedTuple or mapping with the `RegistryArrays` fields, and the
    (N, 8) uint32 static leaf words) -> the port's shards on `mesh`:
    (registry shards, pubkey_root shards, credentials shards), each a
    list of the D shards' values on their devices (`shard_tree`)."""
    from .parallel import shard_registry, shard_tree

    leaves = leaves_to_torch(pubkey_root, credentials, "cpu")
    placed = shard_tree(mesh, {"pubkey_root": leaves.pubkey_root,
                               "credentials": leaves.credentials})
    return (shard_registry(mesh, registry_to_torch(reg, "cpu")),
            [p["pubkey_root"] for p in placed],
            [p["credentials"] for p in placed])


def sharded_forest_to_torch(forest, devices):
    """A port `ShardedMerkleForest` on `devices` in the state of `forest`,
    any object with the JAX sharded forest's `shard_layers` (one layer
    stack per shard, leaves first), `limit_depth`, `length` and
    `n_chunks`: its layers copied, nothing hashed."""
    from .parallel import ShardedMerkleForest

    layers = [[np.asarray(lay) for lay in stack]
              for stack in forest.shard_layers]
    return ShardedMerkleForest.from_shard_layers(
        layers, forest.limit_depth, forest.length, forest.n_chunks, devices)
