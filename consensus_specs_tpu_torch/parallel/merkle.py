"""SSZ merkleization of the registry-scale lists (counterpart of
`consensus_specs_tpu.parallel.merkle`), with kernels K2 and K3.

Chunks are (M, 8) big-endian uint32 words carried as int32 bit patterns
that hold the SSZ little-endian bytes, as in the JAX package.  A tree is
reduced one level per K2 launch on the host; the zero-subtree ladder up
to the SSZ limit depth and the length mix-in are K2 launches of one
message each, so the root never leaves the device.

The sharded forms (`balances_list_root_sharded`,
`validator_registry_root_sharded`) take one contiguous power-of-two run
of the list per shard: each shard reduces its subtree on its device,
the (D, 8) shard roots are gathered to the first shard's device
(`parallel/collectives.py`) and folded there once, then the zero ladder
from the depth of the whole data tree and the length mix-in (JAX
`_sharded_list_root`, where every shard runs the fold on its all-gathered
copy); the root is copied back to every shard's device, so it comes back
once per shard, as JAX replicates it.

Every composite takes `plain`: False runs the plain versions on CPU
tensors and the kernels on CUDA tensors; True runs the plain versions on
any device (the reference the kernels are held against on the card).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .. import _build
from .._uint import U32_MASK, bswap32, i64, shr64, u32_to_i32, umin
from ..ops.sha256 import (sha256_64B_words, sha256_64B_words_plain,
                          sha256_u64_leaves_kernel, zero_hash_words)
from .collectives import gather, on


def _u64_halves(values):
    """(N,) int64 -> the big-endian words of each value's low and high
    32 bits in SSZ little-endian byte order, as int64 in [0, 2**32)."""
    return bswap32(values & U32_MASK), bswap32(shr64(values, 32))


def pack_u64_chunks(values: torch.Tensor) -> torch.Tensor:
    """(N,) int64 -> (ceil(N/4), 8) int32 chunk words, 4 uint64 per
    32-byte chunk (zero-padded)."""
    pad = (-values.shape[0]) % 4
    if pad:
        values = torch.cat([values, values.new_zeros(pad)])
    lo, hi = _u64_halves(values.reshape(-1, 4))
    return u32_to_i32(torch.stack([lo, hi], dim=-1).reshape(-1, 8))


def u64_leaf_words(values: torch.Tensor) -> torch.Tensor:
    """(N,) int64 -> (N, 8) chunk words: each value alone in a chunk (an
    SSZ uint64 field leaf)."""
    lo, hi = _u64_halves(values)
    z = torch.zeros_like(lo)
    return u32_to_i32(torch.stack([lo, hi, z, z, z, z, z, z], dim=-1))


def _hash_fn(plain: bool):
    return sha256_64B_words_plain if plain else sha256_64B_words


def _root_above(level: torch.Tensor, level_depth: int, depth: int,
                plain: bool) -> torch.Tensor:
    """Root of the depth-`depth` tree whose nodes at height `level_depth`
    are `level` (a power-of-two count), the rest of that row being
    zero subtrees."""
    hash_blocks = _hash_fn(plain)
    n = level.shape[0]
    if n & (n - 1) or n == 0:
        raise ValueError(f"tree level of {n} nodes is not a power of two")
    while level.shape[0] > 1:
        level = hash_blocks(level.reshape(-1, 16))
        level_depth += 1
    root = level[0]
    zeros = zero_hash_words(root.device)
    for d in range(level_depth, depth):
        root = hash_blocks(torch.cat([root, zeros[d]])[None])[0]
    return root


def subtree_root(words: torch.Tensor, depth: int,
                 plain: bool = False) -> torch.Tensor:
    """Root of the 2**depth-leaf subtree whose first leaves are `words`
    (N, 8), N a power of two <= 2**depth; the tail is zero subtrees."""
    return _root_above(words, 0, depth, plain)


def mix_in_length(root_words: torch.Tensor, length: int,
                  plain: bool = False) -> torch.Tensor:
    """H(root || le64(length) || zeros): the SSZ list length mix-in."""
    lo, hi = _u64_halves(torch.tensor([i64(length)]))
    tail = torch.zeros(8, dtype=torch.int64)
    tail[0], tail[1] = lo[0], hi[0]
    blk = torch.cat([root_words, u32_to_i32(tail).to(root_words.device)])
    return _hash_fn(plain)(blk[None])[0]


def hash_u64_leaves(values: torch.Tensor, plain: bool = False):
    """The first tree level over the packed chunks of (N,) int64 values,
    N > 4: (ceil(N/8), 8) parent words.  On CUDA (and not `plain`) this is
    K2's leaf mode, which packs in registers; otherwise it packs and hashes
    pairs."""
    if plain or values.device.type == "cpu":
        chunks = pack_u64_chunks(values)
        if chunks.shape[0] % 2:
            chunks = torch.cat([chunks, chunks.new_zeros(1, 8)])
        return sha256_64B_words_plain(chunks.reshape(-1, 16))
    return sha256_u64_leaves_kernel(values)


def _balances_root(balances: torch.Tensor, depth: int,
                   plain: bool) -> torch.Tensor:
    """Root of the depth-`depth` tree over the packed chunks of the (N,)
    int64 `balances`, ceil(N/4) a power of two."""
    n_chunks = -(-balances.shape[0] // 4)
    if n_chunks <= 1:
        return subtree_root(pack_u64_chunks(balances), depth, plain)
    if n_chunks & (n_chunks - 1):
        raise ValueError(f"{n_chunks} chunks is not a power of two")
    return _root_above(hash_u64_leaves(balances, plain), 1, depth, plain)


def balances_list_root(balances: torch.Tensor, length: int,
                       limit_depth: int = 38,
                       plain: bool = False) -> torch.Tensor:
    """hash_tree_root of `List[uint64, 2**40]` (limit 2**38 chunks) over
    the (N,) int64 `balances`, padded so that ceil(N/4) is a power of two;
    `length` is the true element count."""
    return mix_in_length(_balances_root(balances, limit_depth, plain),
                         length, plain)


def _sharded_list_root(local_roots, local_depth: int, limit_depth: int,
                       length: int, plain: bool) -> list:
    """From each shard's (8,) subtree root of depth `local_depth`: the
    (D, 8) roots gathered to the first shard's device and folded there by
    log2 D pair levels, then the zero ladder from `local_depth + log2 D`
    and the length mix-in, once.  One copy of the root per shard, on its
    device."""
    d = len(local_roots)
    if d < 1 or d & (d - 1):
        raise ValueError(f"a sharded list root needs a power-of-two mesh, "
                         f"got {d} shards")
    first = local_roots[0].device
    roots = gather(local_roots, first)
    with on(first):
        root = mix_in_length(_root_above(roots, local_depth, limit_depth,
                                         plain), length, plain)
    return [root.to(r.device, copy=True) for r in local_roots]


def balances_list_root_sharded(parts, length: int, limit_depth: int = 38,
                               plain: bool = False) -> list:
    """`balances_list_root` of the concatenation of `parts`, shard d's (n,)
    int64 balances on its device (JAX `balances_list_root` under
    `shard_map`): n must be a multiple of 4, as a shard boundary inside a
    32-byte chunk would corrupt the root, and n / 4 a power of two.
    Returns the root once per shard."""
    n = parts[0].shape[0]
    if n % 4 or any(p.shape != (n,) for p in parts):
        raise ValueError(f"sharded balances_list_root needs equal "
                         f"chunk-aligned shards (a multiple of 4 uint64), "
                         f"got {[tuple(p.shape) for p in parts]}")
    local_depth = (n // 4 - 1).bit_length()
    local = []
    for p in parts:
        with on(p.device):
            local.append(_balances_root(p, local_depth, plain))
    return _sharded_list_root(local, local_depth, limit_depth, length, plain)


class ValidatorLeaves(NamedTuple):
    """The static per-validator leaves of the registry tree: pubkey root
    and withdrawal credentials, each (N, 8) int32 chunk words."""

    pubkey_root: torch.Tensor
    credentials: torch.Tensor


def validator_records_root_plain(leaves: ValidatorLeaves, effective_balance,
                                 slashed, activation_eligibility_epoch,
                                 activation_epoch, exit_epoch,
                                 withdrawable_epoch, length=None, index=None):
    """(N, 8) root words of each Validator record in plain PyTorch; rows
    with index >= `length` (when given) are zero chunks.  With `index`
    ((M,) int64), row i is the record of validator min(index[i], N - 1),
    read as unsigned: (M, 8) words."""
    if index is not None:
        safe = umin(index, effective_balance.shape[0] - 1)
        leaves = ValidatorLeaves(leaves.pubkey_root[safe],
                                 leaves.credentials[safe])
        (effective_balance, slashed, activation_eligibility_epoch,
         activation_epoch, exit_epoch, withdrawable_epoch) = (
            a[safe] for a in (effective_balance, slashed,
                              activation_eligibility_epoch, activation_epoch,
                              exit_epoch, withdrawable_epoch))
    f = [leaves.pubkey_root, leaves.credentials,
         u64_leaf_words(effective_balance),
         u64_leaf_words(slashed.to(torch.int64)),
         u64_leaf_words(activation_eligibility_epoch),
         u64_leaf_words(activation_epoch),
         u64_leaf_words(exit_epoch),
         u64_leaf_words(withdrawable_epoch)]
    level = torch.stack(f, dim=1)              # (N, 8 leaves, 8 words)
    for _ in range(3):
        level = sha256_64B_words_plain(
            level.reshape(level.shape[0], level.shape[1] // 2, 16))
    return _zero_rows_from(level[:, 0, :], length)


def _zero_rows_from(rows: torch.Tensor, length) -> torch.Tensor:
    if length is None or length >= rows.shape[0]:
        return rows
    rows = rows.clone()
    rows[max(int(length), 0):] = 0
    return rows


@functools.cache
def _lib():
    lib = _build.load("records_root")
    lib.records_root_launch.argtypes = (
        [ctypes.c_void_p] * 10 + [ctypes.c_int64] * 3 + [ctypes.c_void_p])
    lib.records_root_launch.restype = ctypes.c_int
    return lib


def validator_records_root_kernel(leaves: ValidatorLeaves, effective_balance,
                                  slashed, activation_eligibility_epoch,
                                  activation_epoch, exit_epoch,
                                  withdrawable_epoch, length=None, index=None):
    """K3 on CUDA tensors, the pad-row masking fused in; with `index`,
    K3's gather mode, which reads the rows through the index."""
    u64s = [effective_balance, activation_eligibility_epoch,
            activation_epoch, exit_epoch, withdrawable_epoch]
    _build.require_cuda("records_root", leaves.pubkey_root,
                        leaves.credentials, slashed, *u64s)
    n = effective_balance.shape[0]
    for w in leaves:
        if w.dtype != torch.int32 or w.shape != (n, 8):
            raise ValueError(f"records_root: leaves must be ({n}, 8) int32")
    if slashed.dtype != torch.bool or slashed.shape != (n,) or any(
            a.dtype != torch.int64 or a.shape != (n,) for a in u64s):
        raise ValueError("records_root: fields must be (N,) int64, "
                         "slashed (N,) bool")
    m, counter, index_ptr = n, "records_root", None
    if index is not None:
        _build.require_cuda("records_root", effective_balance, index)
        if index.dtype != torch.int64 or index.dim() != 1:
            raise ValueError("records_root: index must be (M,) int64")
        if index.shape[0] and not n:
            raise ValueError("records_root: gather from an empty registry")
        m, counter, index_ptr = (index.shape[0], "records_root_gather",
                                 index.data_ptr())
    out = torch.empty((m, 8), dtype=torch.int32,
                      device=effective_balance.device)
    if m:
        length = m if length is None else min(int(length), m)
        _build.check(_lib().records_root_launch(
            leaves.pubkey_root.data_ptr(), leaves.credentials.data_ptr(),
            effective_balance.data_ptr(), slashed.data_ptr(),
            activation_eligibility_epoch.data_ptr(),
            activation_epoch.data_ptr(), exit_epoch.data_ptr(),
            withdrawable_epoch.data_ptr(), index_ptr, out.data_ptr(), m, n,
            length, _build.stream_ptr(out)), counter)
        _build.launches[counter] += 1
    return out


def validator_records_root(leaves: ValidatorLeaves, effective_balance,
                           slashed, activation_eligibility_epoch,
                           activation_epoch, exit_epoch, withdrawable_epoch,
                           length=None, index=None):
    """(N, 8) root words of each Validator record: the plain version for
    CPU tensors, K3 for CUDA tensors.  Rows with index >= `length` (when
    given) are zero chunks, as `validator_registry_root` needs them.
    With `index` ((M,) int64), the (M, 8) roots of validators
    min(index[i], N - 1): `bench.py`'s `dirty_record_roots`, K3's gather
    mode on CUDA."""
    fn = (validator_records_root_plain
          if effective_balance.device.type == "cpu"
          else validator_records_root_kernel)
    return fn(leaves, effective_balance, slashed,
              activation_eligibility_epoch, activation_epoch, exit_epoch,
              withdrawable_epoch, length, index)


def validator_registry_root(record_roots: torch.Tensor, length: int,
                            limit_depth: int = 40,
                            plain: bool = False) -> torch.Tensor:
    """hash_tree_root of `List[Validator, 2**40]` from the (N, 8) record
    roots, N a power of two.  Rows with index >= `length` are masked to
    zero chunks: SSZ pads a list's leaf level with zero chunks, not with
    the record root of a zero Validator."""
    record_roots = _zero_rows_from(record_roots, length)
    return mix_in_length(subtree_root(record_roots, limit_depth, plain),
                         length, plain)


def shard_length(length: int, shard: int, n_local: int) -> int:
    """How many of shard `shard`'s `n_local` rows lie below the global
    `length`: its rows are the global indices [shard n_local,
    (shard + 1) n_local)."""
    return min(max(int(length) - shard * n_local, 0), n_local)


def validator_registry_root_sharded(parts, length: int, limit_depth: int = 40,
                                    plain: bool = False) -> list:
    """`validator_registry_root` of the concatenation of `parts`, shard
    d's (n, 8) record roots on its device, n a power of two: rows whose
    GLOBAL index d n + i is at or past `length` are masked to zero chunks
    (JAX `validator_registry_root` with `axis_index`).  Returns the root
    once per shard."""
    n = parts[0].shape[0]
    if n & (n - 1) or any(p.shape != (n, 8) for p in parts):
        raise ValueError(f"sharded registry root needs equal power-of-two "
                         f"shards, got {[tuple(p.shape) for p in parts]}")
    local_depth = (n - 1).bit_length()
    local = []
    for d, p in enumerate(parts):
        with on(p.device):
            rows = _zero_rows_from(p, shard_length(length, d, n))
            local.append(subtree_root(rows, local_depth, plain))
    return _sharded_list_root(local, local_depth, limit_depth, length, plain)
