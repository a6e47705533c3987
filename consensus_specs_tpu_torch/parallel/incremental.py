"""Incremental merkleization over persisted layer stacks (counterpart of
`consensus_specs_tpu.parallel.incremental`, single device), with kernels
K4, K5 and K6 (`csrc/incremental.cu`) and K2.

A `MerkleForest` keeps every level of one SSZ list's data tree on the
device, so an epoch step re-hashes only the root-to-leaf paths of the
dirty leaves, and proofs are gathers of stored nodes:

- `update_dirty` scatters the new leaf words (K4, leaf scatter), then per
  level either hashes the pairs under the dirty parents and writes them
  back (K4, one launch per sparse level: a level wider than the padded
  dirty rung) or re-hashes the whole level (K2: the dense tail, every
  level no wider than the rung).  The regime is chosen as in JAX, level
  by level from the rung.
- `gather_proof_paths` gathers the leaf and the bottom-up sibling path
  of each index (K6); `MerkleForest.emit_proofs` adds the zero-subtree
  ladder up to the list's limit depth and the length chunk on the host.
- `gather_balance_chunks` packs the dirty chunks of a uint64 balances
  list (K5): the bridge from a swept balances array to leaf words.

Layout: the 2**(d+1) - 1 node rows of a depth-d forest lie in one
contiguous (rows, 8) int32 buffer, level k a view of its 2**(d-k) rows
(leaves first, the data root last).  Words are int32 bit patterns of
big-endian uint32 (`_uint`); indices are int64 tensors, read as unsigned
(a negative index is out of range).

`ShardedMerkleForest` splits the data tree at a level into one
contiguous subtree per mesh device, each a layer stack on its own device
(K2, K4, K6 there); the few levels above the shard roots, the zero
ladder and the length mix-in are folded on the host, as JAX folds them.

Two differences from the JAX module: the port updates a forest's layers
in place (JAX returns new arrays, which would copy the 64 MiB registry
forest every step), and its entry points are synchronous (the
`*_async` futures, the fault, checkpoint and quarantine seams and
telemetry are not ported yet).

Each kernel wrapper runs the plain PyTorch version for CPU tensors and
launches its kernel for CUDA tensors; `plain=True` runs the plain
versions on any device (the reference the kernels are held against on
the card).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
from typing import NamedTuple

import numpy as np
import torch

from .. import _build, resolve_device
from .._uint import from_numpy_u32, from_numpy_u64, shr64, to_numpy_u32, umin
from ..ops.sha256 import (ZERO_HASH_WORDS, sha256_64B_words,
                          sha256_64B_words_plain)
from .collectives import on
from .merkle import pack_u64_chunks

# the padded dirty-count ladder: a dirty set of n indices is padded to
# the next power of two, rounded up to a rung (larger sets: the power of
# two itself); pad lanes carry the out-of-range sentinel
_DIRTY_STEPS = (64, 1024, 16384)


def _bucket(n: int) -> int:
    """Padded dirty count for n live indices."""
    b = 1 if n <= 1 else 1 << (n - 1).bit_length()
    for step in _DIRTY_STEPS:
        if b <= step:
            return step
    return b


def _as_index(idx) -> torch.Tensor:
    """Indices (a tensor, numpy array or sequence) -> an (M,) int64
    tensor (on the tensor's device, else the CPU)."""
    if isinstance(idx, torch.Tensor):
        return idx.reshape(-1).to(torch.int64)
    return torch.from_numpy(np.asarray(idx, dtype=np.int64).reshape(-1))


def pad_dirty_idx(dirty_idx, capacity: int) -> torch.Tensor:
    """Sentinel-pad a dirty index set to its `_bucket` rung: rows past the
    live count carry `capacity`, which every scatter drops.  (M,) int64,
    on the device of `dirty_idx` when it is a tensor, else the CPU."""
    idx = _as_index(dirty_idx)
    out = torch.full((_bucket(idx.shape[0]),), int(capacity),
                     dtype=torch.int64, device=idx.device)
    out[:idx.shape[0]] = idx
    return out


def dirty_chunks_from_validators(dirty_validator_idx) -> torch.Tensor:
    """Dirty balance-chunk indices of a set of dirty validator indices (4
    uint64 per chunk): sorted, without duplicates, int64."""
    return torch.unique(_as_index(dirty_validator_idx) >> 2)


def _as_words(words, device) -> torch.Tensor:
    """(n, 8) chunk words (numpy uint32 or an int32 tensor) -> an int32
    tensor on `device`."""
    if isinstance(words, torch.Tensor):
        if words.dtype != torch.int32:
            raise ValueError(f"chunk words must be int32, got {words.dtype}")
        words = words.to(device)
    else:
        words = from_numpy_u32(words, device)
    if words.dim() != 2 or words.shape[1] != 8:
        raise ValueError(f"expected (n, 8) chunk words, got "
                         f"{tuple(words.shape)}")
    return words


def _use_plain(t: torch.Tensor, plain: bool) -> bool:
    return plain or t.device.type == "cpu"


# --- kernels K4, K5, K6 and their plain versions ------------------------------


@functools.cache
def _lib():
    lib = _build.load("incremental")
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.leaf_scatter_launch.argtypes = [p, p, p, i64, i64, p]
    lib.update_level_launch.argtypes = [p, p, p, i64, ctypes.c_int, i64, p]
    lib.balance_chunks_launch.argtypes = [p, p, p, i64, i64, p]
    lib.proof_paths_launch.argtypes = [p, ctypes.c_int, p, p, p, i64, p]
    for f in ("leaf_scatter_launch", "update_level_launch",
              "balance_chunks_launch", "proof_paths_launch"):
        getattr(lib, f).restype = ctypes.c_int
    return lib


def _check_index(name: str, idx: torch.Tensor) -> None:
    if idx.dtype != torch.int64 or idx.dim() != 1:
        raise ValueError(f"{name}: indices must be (M,) int64, got "
                         f"{idx.dtype} {tuple(idx.shape)}")


def scatter_leaves_plain(level0, idx, words) -> None:
    """level0[idx[i]] = words[i], dropping idx[i] >= len(level0)."""
    keep = (idx >= 0) & (idx < level0.shape[0])
    level0[idx[keep]] = words[keep]


def update_level_plain(child, parent, idx, shift: int) -> None:
    """One sparse level: for each parent = idx[i] >> shift inside the
    level, parent_level[parent] = H(child[2 parent] || child[2 parent + 1])."""
    p = shr64(idx, shift)
    p = p[p < parent.shape[0]]
    parent[p] = sha256_64B_words_plain(child.reshape(-1, 16)[p])


def scatter_leaves(level0, idx, words, plain: bool = False) -> None:
    """K4's leaf scatter (in place); the plain version for CPU tensors."""
    _check_index("leaf_scatter", idx)
    if words.shape != (idx.shape[0], 8):
        raise ValueError(f"leaf_scatter: {idx.shape[0]} indices need "
                         f"({idx.shape[0]}, 8) words, got "
                         f"{tuple(words.shape)}")
    if _use_plain(level0, plain):
        return scatter_leaves_plain(level0, idx, words)
    _build.require_cuda("update_level", level0, idx, words)
    if idx.shape[0]:
        _build.check(_lib().leaf_scatter_launch(
            idx.data_ptr(), words.data_ptr(), level0.data_ptr(),
            idx.shape[0], level0.shape[0], _build.stream_ptr(level0)),
            "leaf_scatter")
        _build.launches["update_level"] += 1


def update_level(child, parent, idx, shift: int, plain: bool = False) -> None:
    """K4 on one sparse level (in place); the plain version for CPU
    tensors.  `child` has 2 len(parent) rows; `idx` are leaf indices and
    `shift` the parent level's height."""
    _check_index("update_level", idx)
    if child.shape[0] != 2 * parent.shape[0] or shift < 1:
        raise ValueError("update_level: child must have twice the parent's "
                         "rows and shift must be >= 1")
    if _use_plain(child, plain):
        return update_level_plain(child, parent, idx, shift)
    _build.require_cuda("update_level", child, parent, idx)
    if idx.shape[0]:
        _build.check(_lib().update_level_launch(
            idx.data_ptr(), child.data_ptr(), parent.data_ptr(),
            idx.shape[0], shift, parent.shape[0], _build.stream_ptr(child)),
            "update_level")
        _build.launches["update_level"] += 1


def gather_balance_chunks_plain(balances, chunk_idx) -> torch.Tensor:
    """(N,) int64 balances, (M,) chunk indices -> (M, 8) chunk words:
    each chunk's 4 values packed SSZ little-endian, values past N zero."""
    n = balances.shape[0]
    c = chunk_idx[:, None]
    flat = c * 4 + torch.arange(4, device=c.device)
    valid = (c >= 0) & (c <= n // 4) & (flat < n)   # c <= n // 4: no wrap
    vals = torch.zeros(flat.shape, dtype=torch.int64, device=c.device)
    if n:
        vals = torch.where(valid, balances[torch.where(valid, flat, 0)], vals)
    return pack_u64_chunks(vals.reshape(-1))


def gather_balance_chunks(balances, chunk_idx, out=None,
                          plain: bool = False) -> torch.Tensor:
    """K5 (the plain version for CPU tensors): (N,) int64 balances and
    (M,) int64 chunk indices -> (M, 8) int32 chunk words, written into
    `out` when given (e.g. a forest's leaf level)."""
    _check_index("balance_chunks", chunk_idx)
    if balances.dtype != torch.int64 or balances.dim() != 1:
        raise ValueError("balance_chunks: balances must be (N,) int64")
    m = chunk_idx.shape[0]
    if out is not None and (out.shape != (m, 8) or out.dtype != torch.int32
                            or not out.is_contiguous()):
        raise ValueError(f"balance_chunks: out must be a contiguous ({m}, 8)"
                         " int32 tensor")
    if _use_plain(balances, plain):
        words = gather_balance_chunks_plain(balances, chunk_idx)
        return words if out is None else out.copy_(words)
    if out is None:
        out = torch.empty((m, 8), dtype=torch.int32, device=balances.device)
    _build.require_cuda("balance_chunks", balances, chunk_idx, out)
    if m:
        _build.check(_lib().balance_chunks_launch(
            balances.data_ptr(), chunk_idx.data_ptr(), out.data_ptr(), m,
            balances.shape[0], _build.stream_ptr(out)), "balance_chunks")
        _build.launches["balance_chunks"] += 1
    return out


# the JAX module's name for the flagship's use: the dirty chunks' leaf
# words of a swept balances array, for `MerkleForest.update`
dirty_balance_leaves = gather_balance_chunks


def gather_proof_paths_plain(layers, idx, depth: int):
    cap = layers[0].shape[0]
    leaves = layers[0][umin(idx, cap - 1)]
    sibs = [layers[lvl][umin(shr64(idx, lvl) ^ 1, (1 << (depth - lvl)) - 1)]
            for lvl in range(depth)]
    if not sibs:
        return leaves, leaves.new_zeros((idx.shape[0], 0, 8))
    return leaves, torch.stack(sibs, dim=1)


def gather_proof_paths(layers, idx, depth: int, plain: bool = False):
    """(M,) leaf indices -> ((M, 8) leaf words, (M, depth, 8) sibling words
    bottom-up) from a forest's layers: K6 on CUDA, the plain version for
    CPU tensors."""
    _check_index("proof_paths", idx)
    if len(layers) != depth + 1 or any(
            lay.shape != (1 << (depth - k), 8) for k, lay in enumerate(layers)):
        raise ValueError(f"proof_paths: expected {depth + 1} halving layers")
    if _use_plain(idx, plain):
        return gather_proof_paths_plain(layers, idx, depth)
    _build.require_cuda("proof_paths", idx, *layers)
    m = idx.shape[0]
    leaves = torch.empty((m, 8), dtype=torch.int32, device=idx.device)
    paths = torch.empty((m, depth, 8), dtype=torch.int32, device=idx.device)
    if m:
        ptrs = (ctypes.c_void_p * (depth + 1))(
            *(lay.data_ptr() for lay in layers))
        _build.check(_lib().proof_paths_launch(
            ptrs, depth, idx.data_ptr(), leaves.data_ptr(), paths.data_ptr(),
            m, _build.stream_ptr(idx)), "proof_paths")
        _build.launches["proof_paths"] += 1
    return leaves, paths


# --- layer stacks -------------------------------------------------------------


def _alloc_layers(depth: int, device) -> tuple:
    """depth + 1 views, leaves first, into one (2**(depth+1) - 1, 8) int32
    buffer."""
    buf = torch.empty(((2 << depth) - 1, 8), dtype=torch.int32, device=device)
    views, off = [], 0
    for k in range(depth + 1):
        views.append(buf[off:off + (1 << (depth - k))])
        off += 1 << (depth - k)
    return tuple(views)


def _hash_level(child, parent, plain: bool) -> None:
    """parent = H over every pair of `child` (K2, or its plain version)."""
    blocks = child.reshape(-1, 16)
    if plain:
        parent.copy_(sha256_64B_words_plain(blocks))
    else:
        sha256_64B_words(blocks, out=parent)


def _hash_up(layers, plain: bool = False) -> tuple:
    """Fill levels 1.. of `layers` from level 0: one K2 launch per level."""
    for k in range(len(layers) - 1):
        _hash_level(layers[k], layers[k + 1], plain)
    return layers


def build_layers(leaves, depth: int, plain: bool = False) -> tuple:
    """(2**depth, 8) leaf words -> depth + 1 layers (leaves first, the data
    root last), every level kept."""
    if leaves.shape != (1 << depth, 8):
        raise ValueError(f"expected ({1 << depth}, 8) leaves, got "
                         f"{tuple(leaves.shape)}")
    layers = _alloc_layers(depth, leaves.device)
    layers[0].copy_(leaves)
    return _hash_up(layers, plain)


def update_dirty(layers, dirty_idx, new_leaf_words, depth: int,
                 plain: bool = False) -> tuple:
    """Re-hash the dirty root-to-leaf paths of a layer stack, in place.

    layers: depth + 1 tensors (`build_layers`); dirty_idx: (M,) int64 leaf
    indices padded with the sentinel 2**depth (out-of-range rows are
    dropped); new_leaf_words: (M, 8) int32.  Duplicate indices must carry
    equal words.  Per level: K4 where the level is wider than M, K2 over
    the whole level where it is not.  Returns `layers`."""
    rung = dirty_idx.shape[0]
    scatter_leaves(layers[0], dirty_idx, new_leaf_words, plain=plain)
    for lvl in range(depth):
        size = 1 << (depth - lvl - 1)       # nodes in level lvl + 1
        if size <= rung:
            # the dense tail: every level from here up is narrower
            _hash_level(layers[lvl], layers[lvl + 1], plain)
        else:
            update_level(layers[lvl], layers[lvl + 1], dirty_idx, lvl + 1,
                         plain=plain)
    return layers


# --- the host tail: zero ladder, length mix-in, proofs -------------------------


ZERO_HASHES = tuple(row.astype(">u4").tobytes() for row in ZERO_HASH_WORDS)


def _words_to_bytes(words) -> bytes:
    """(8,) int32 word tensor or uint32 array -> the chunk's 32 bytes."""
    if isinstance(words, torch.Tensor):
        words = to_numpy_u32(words)
    return np.asarray(words, dtype=np.uint32).astype(">u4").tobytes()


def _bytes_to_words(chunk: bytes) -> torch.Tensor:
    """32 bytes -> their (8,) int32 word tensor on the CPU."""
    return from_numpy_u32(np.frombuffer(chunk, dtype=">u4"), "cpu")


def _length_chunk(length: int) -> bytes:
    return int(length).to_bytes(8, "little") + bytes(24)


def _finish_root(data_root: bytes, data_depth: int, limit_depth: int,
                 length: int) -> bytes:
    """The zero-subtree fold from `data_depth` to `limit_depth`, then the
    SSZ length mix-in, on the host."""
    root = data_root
    for lvl in range(data_depth, limit_depth):
        root = hashlib.sha256(root + ZERO_HASHES[lvl]).digest()
    return hashlib.sha256(root + _length_chunk(length)).digest()


class SSZProof(NamedTuple):
    """One SSZ single-proof for a leaf chunk of a list tree.  `branch`
    runs bottom-up: `limit_depth` data-tree siblings, then the length
    chunk, so it verifies with `is_valid_merkle_branch(leaf, branch,
    limit_depth + 1, index, root)`; `gindex` is the chunk's generalized
    index in the list type (data tree at gindex 2)."""

    index: int
    gindex: int
    leaf: bytes
    branch: tuple

    @property
    def depth(self) -> int:
        return len(self.branch)


def _assemble_proofs(host, indices, data_depth: int, limit_depth: int,
                     length: int) -> list:
    """Gathered (leaves, paths) as uint32 arrays -> SSZProofs: the stored
    siblings, the zero ladder up to `limit_depth`, the length chunk."""
    leaves, paths = host
    zero_tail = list(ZERO_HASHES[data_depth:limit_depth])
    len_chunk = _length_chunk(length)
    proofs = []
    for row, i in enumerate(indices):
        branch = [_words_to_bytes(paths[row, lvl]) for lvl in range(data_depth)]
        branch.extend(zero_tail)
        branch.append(len_chunk)
        proofs.append(SSZProof(index=int(i), gindex=(2 << limit_depth) + int(i),
                               leaf=_words_to_bytes(leaves[row]),
                               branch=tuple(branch)))
    return proofs


def is_valid_merkle_branch(leaf: bytes, branch, depth: int, index: int,
                           root: bytes) -> bool:
    """The phase0 spec's `is_valid_merkle_branch`, with hashlib."""
    value = bytes(leaf)
    for i in range(depth):
        if index >> i & 1:
            value = hashlib.sha256(bytes(branch[i]) + value).digest()
        else:
            value = hashlib.sha256(value + bytes(branch[i])).digest()
    return value == bytes(root)


def verify_proof(proof: SSZProof, root: bytes) -> bool:
    """Check one emitted proof against a 32-byte list root."""
    return is_valid_merkle_branch(proof.leaf, proof.branch, proof.depth,
                                  proof.index, root)


# --- the forest ---------------------------------------------------------------


class MerkleForest:
    """The persisted merkleization state of one SSZ list on one device.

    Holds every level of the (power-of-two padded) data tree; `update`
    re-hashes only the dirty root-to-leaf paths, in place; `root` and
    `emit_proofs` finish on the host.  `leaf_words` is the (n, 8) chunk
    words of the list's bottom level (numpy uint32 or an int32 tensor);
    `length` is the SSZ element count for the length mix-in.  On CUDA the
    forest runs K2, K4 and K6; on the CPU, or with `plain`, their plain
    versions."""

    def __init__(self, leaf_words, limit_depth: int, length: int,
                 device="cuda", plain: bool = False):
        dev = resolve_device(device)
        words = _as_words(leaf_words, dev)
        n = words.shape[0]
        self._setup(max(n - 1, 0).bit_length(), limit_depth, length, n, dev,
                    plain)
        self.layers[0][:n] = words
        self.layers[0][n:] = 0
        _hash_up(self.layers, plain)

    def _setup(self, depth, limit_depth, length, n_chunks, device, plain):
        if n_chunks > 1 << limit_depth:
            raise ValueError(f"{n_chunks} chunks exceed the limit 2**"
                             f"{limit_depth}")
        self.data_depth = depth
        self.limit_depth = int(limit_depth)
        self.length = int(length)
        self.n_chunks = int(n_chunks)
        self.device = device
        self.plain = plain
        self.layers = _alloc_layers(depth, device)

    @classmethod
    def _empty(cls, depth, limit_depth, length, n_chunks, device, plain):
        self = cls.__new__(cls)
        self._setup(depth, limit_depth, length, n_chunks, device, plain)
        return self

    @classmethod
    def from_layers(cls, layers, limit_depth: int, length: int,
                    n_chunks: int, device="cuda",
                    plain: bool = False) -> "MerkleForest":
        """A forest from an already-computed layer stack (numpy uint32 or
        int32 tensors, leaves first: e.g. `np.asarray` of each layer of a
        JAX forest), with no hashing.  Shapes are checked (each level
        halves); the content is the caller's."""
        depth = len(layers) - 1
        for k, lay in enumerate(layers):
            if tuple(lay.shape) != (1 << (depth - k), 8):
                raise ValueError(f"layer {k} has shape {tuple(lay.shape)}, "
                                 f"expected {(1 << (depth - k), 8)}")
        self = cls._empty(depth, limit_depth, length, n_chunks,
                          resolve_device(device), plain)
        for dst, lay in zip(self.layers, layers):
            dst.copy_(_as_words(lay, self.device))
        return self

    @property
    def capacity(self) -> int:
        """Leaf slots of the stored tree (a power of two)."""
        return 1 << self.data_depth

    def update(self, dirty_idx, new_leaf_words) -> None:
        """Write `new_leaf_words` at the leaf indices `dirty_idx` (host or
        device; duplicates only with equal words, as
        `dirty_chunks_from_validators` ensures) and re-hash the touched
        paths.  Indices >= `capacity` are dropped, so callers may pad to a
        rung themselves with `pad_dirty_idx` and keep both arrays on the
        device; shorter leaf words are zero-padded to the rung."""
        idx = _as_index(dirty_idx)
        m = idx.shape[0]
        if m == 0:
            return
        if _bucket(m) != m:
            idx = pad_dirty_idx(idx, self.capacity)
        idx = idx.to(self.device)
        rung = idx.shape[0]
        leaves = _as_words(new_leaf_words, self.device)
        if leaves.shape[0] > rung:
            raise ValueError(f"{leaves.shape[0]} leaf rows for {m} indices")
        if leaves.shape[0] < rung:
            leaves = torch.cat([leaves, leaves.new_zeros(
                (rung - leaves.shape[0], 8))])
        update_dirty(self.layers, idx, leaves, self.data_depth, self.plain)

    def root_bytes(self) -> bytes:
        """The list's hash_tree_root, 32 bytes."""
        return _finish_root(_words_to_bytes(self.layers[-1][0]),
                            self.data_depth, self.limit_depth, self.length)

    def root(self) -> torch.Tensor:
        """The list's hash_tree_root as (8,) int32 words on the CPU."""
        return _bytes_to_words(self.root_bytes())

    def emit_proofs(self, indices) -> list:
        """SSZ single-proofs for the leaf chunks `indices`: one gather of
        the stored paths (K6 on CUDA) padded to a rung, then the zero
        ladder and the length chunk on the host."""
        indices = [int(i) for i in indices]
        if not indices:
            return []
        if min(indices) < 0 or max(indices) >= self.n_chunks:
            raise ValueError("proof index outside the list's chunks")
        idx = torch.zeros(_bucket(len(indices)), dtype=torch.int64)
        idx[:len(indices)] = torch.tensor(indices)
        leaves, paths = gather_proof_paths(
            self.layers, idx.to(self.device), self.data_depth,
            plain=self.plain)
        return _assemble_proofs((to_numpy_u32(leaves), to_numpy_u32(paths)),
                                indices, self.data_depth, self.limit_depth,
                                self.length)


def merkleize_dirty(forest: MerkleForest, dirty_idx,
                    new_leaf_words) -> torch.Tensor:
    """Apply a dirty-set update and return the list root's (8,) words."""
    forest.update(dirty_idx, new_leaf_words)
    return forest.root()


def emit_proofs(forest: MerkleForest, indices) -> list:
    """`forest.emit_proofs(indices)`."""
    return forest.emit_proofs(indices)


def _as_u64(values, device) -> torch.Tensor:
    if isinstance(values, torch.Tensor):
        if values.dtype != torch.int64:
            raise ValueError(f"balances must be int64, got {values.dtype}")
        return values.reshape(-1).to(device)
    return from_numpy_u64(np.asarray(values).reshape(-1), device)


def balances_forest(balances, length, limit_depth: int = 38, device="cuda",
                    plain: bool = False) -> MerkleForest:
    """Forest over `List[uint64, 2**40]` (4 values per chunk, limit 2**38
    chunks) from (N,) balances (numpy uint64 or an int64 tensor).  The
    leaf level, padded, is one K5 launch over every chunk index."""
    dev = resolve_device(device)
    bal = _as_u64(balances, dev)
    n_chunks = -(-bal.shape[0] // 4)
    depth = max(n_chunks - 1, 0).bit_length()
    forest = MerkleForest._empty(depth, limit_depth, length, n_chunks, dev,
                                 plain)
    gather_balance_chunks(bal, torch.arange(1 << depth, device=dev),
                          out=forest.layers[0], plain=plain)
    _hash_up(forest.layers, plain)
    return forest


def registry_forest(record_roots, length, limit_depth: int = 40,
                    device="cuda", plain: bool = False) -> MerkleForest:
    """Forest over `List[Validator, 2**40]` from (n, 8) record-root words
    (`validator_records_root`); rows past `length` must already be zero
    chunks."""
    return MerkleForest(record_roots, limit_depth, length, device, plain)


# --- the mesh-sharded forest -------------------------------------------------


def _top_tree_levels(shard_roots: list) -> list:
    """Every level of the tree above the (S,) shard roots (32-byte
    chunks), the shard-root level first; `[-1][0]` is the data root."""
    levels = [list(shard_roots)]
    while len(levels[-1]) > 1:
        row = levels[-1]
        levels.append([hashlib.sha256(row[i] + row[i + 1]).digest()
                       for i in range(0, len(row), 2)])
    return levels


def _fold_shard_roots(shard_roots: list) -> bytes:
    """The data root over the shard roots: the one top fold, shared with
    the proof siblings above the shards."""
    return _top_tree_levels(shard_roots)[-1][0]


class ShardedMerkleForest:
    """A `MerkleForest` split over a mesh (JAX `:510`): the 2**data_depth
    leaf data tree splits at level `local_depth` into `n_shards`
    contiguous subtrees, shard i's layer stack on `devices[i]`.  `update`
    dispatches only to the shards a dirty set touches; `root` and
    `emit_proofs` fold the shard roots on the host.  The tree is the
    single forest's, so the root equals `MerkleForest`'s over the same
    leaves.

    The mesh comes from `partition.build_mesh` (`n_shards` cards, the
    `device_ids` cards, or the explicit `devices`, which may repeat); the
    shard count must be a power of two (with no argument, the cards are
    cut to `mesh_rung` of their count).  On CUDA the shards run K2, K4
    and K6; on the CPU their plain versions."""

    def __init__(self, leaf_words, limit_depth: int, length: int,
                 n_shards: int | None = None, device_ids=None, devices=None):
        self._setup(self._devices(n_shards, device_ids, devices),
                    limit_depth, length)
        first = self.devices[0]
        words = _as_words(leaf_words, first)
        n = words.shape[0]
        self._size(n)
        local = self.shard_capacity
        self.shard_layers = []
        for i, dev in enumerate(self.devices):
            with on(dev):
                leaves = torch.zeros((local, 8), dtype=torch.int32,
                                     device=dev)
                part = words[i * local:min((i + 1) * local, n)]
                leaves[:part.shape[0]] = part.to(dev)
                self.shard_layers.append(
                    build_layers(leaves, self.local_depth))

    @staticmethod
    def _devices(n_shards, device_ids, devices) -> list:
        from .partition import build_mesh, mesh_rung

        mesh = build_mesh(n_devices=n_shards, device_ids=device_ids,
                          devices=devices)
        devs = list(mesh.devices)
        if n_shards is None and device_ids is None and devices is None:
            devs = devs[:mesh_rung(len(devs))]
        if len(devs) & (len(devs) - 1):
            raise ValueError(f"a sharded forest needs a power-of-two shard "
                             f"count, got {len(devs)} (quantize with "
                             f"mesh_rung)")
        return devs

    def _setup(self, devices, limit_depth, length):
        self.devices = devices
        self.n_shards = len(devices)
        self.shard_depth = (self.n_shards - 1).bit_length()
        self.limit_depth = int(limit_depth)
        self.length = int(length)

    def _size(self, n_chunks: int):
        if n_chunks > 1 << self.limit_depth:
            raise ValueError(f"{n_chunks} chunks exceed the limit 2**"
                             f"{self.limit_depth}")
        self.n_chunks = int(n_chunks)
        self.data_depth = max(max(n_chunks - 1, 0).bit_length(),
                              self.shard_depth)
        self.local_depth = self.data_depth - self.shard_depth

    @classmethod
    def from_shard_layers(cls, shard_layers, limit_depth: int, length: int,
                          n_chunks: int, devices) -> "ShardedMerkleForest":
        """A forest from already-computed shard layer stacks (numpy uint32
        or int32 tensors, leaves first: e.g. each layer of a JAX
        `ShardedMerkleForest`'s `shard_layers`), shard i's placed on
        `devices[i]`, with no hashing.  Shapes are checked; the content
        is the caller's."""
        from .partition import build_mesh

        self = cls.__new__(cls)
        self._setup(list(build_mesh(devices=devices).devices), limit_depth,
                    length)
        if len(shard_layers) != self.n_shards:
            raise ValueError(f"{len(shard_layers)} layer stacks for "
                             f"{self.n_shards} devices")
        self._size(n_chunks)
        depth = self.local_depth
        self.shard_layers = []
        for layers, dev in zip(shard_layers, self.devices):
            if len(layers) != depth + 1 or any(
                    tuple(lay.shape) != (1 << (depth - k), 8)
                    for k, lay in enumerate(layers)):
                raise ValueError(f"expected {depth + 1} halving layers of "
                                 f"{1 << depth} leaves")
            stack = _alloc_layers(depth, dev)
            for dst, lay in zip(stack, layers):
                dst.copy_(_as_words(lay, dev))
            self.shard_layers.append(stack)
        return self

    @property
    def capacity(self) -> int:
        return 1 << self.data_depth

    @property
    def shard_capacity(self) -> int:
        return 1 << self.local_depth

    def update(self, dirty_idx, new_leaf_words) -> None:
        """Write `new_leaf_words` at the GLOBAL leaf indices `dirty_idx`
        and re-hash the touched paths, shard by shard: each touched shard
        gets one `update_dirty` on its device (its local indices padded to
        their rung), an untouched shard none.  Leaf words past the index
        count are ignored; indices at or past `capacity` are dropped."""
        idx = _as_index(dirty_idx).cpu()
        m = idx.shape[0]
        if m == 0:
            return
        words = _as_words(new_leaf_words, "cpu")
        if words.shape[0] < m:
            raise ValueError(f"{words.shape[0]} leaf rows for {m} indices")
        words = words[:m]
        shard_of = shr64(idx, self.local_depth)
        for s, dev in enumerate(self.devices):
            hit = shard_of == s
            if not bool(hit.any()):
                continue
            local = idx[hit] & (self.shard_capacity - 1)
            padded = pad_dirty_idx(local, self.shard_capacity)
            leaves = torch.zeros((padded.shape[0], 8), dtype=torch.int32)
            leaves[:local.shape[0]] = words[hit]
            with on(dev):
                update_dirty(self.shard_layers[s], padded.to(dev),
                             leaves.to(dev), self.local_depth)

    def _shard_roots(self) -> list:
        return [_words_to_bytes(layers[-1][0]) for layers in self.shard_layers]

    def root_bytes(self) -> bytes:
        """The list's hash_tree_root, 32 bytes."""
        return _finish_root(_fold_shard_roots(self._shard_roots()),
                            self.data_depth, self.limit_depth, self.length)

    def root(self) -> torch.Tensor:
        """The list's hash_tree_root as (8,) int32 words on the CPU."""
        return _bytes_to_words(self.root_bytes())

    def emit_proofs(self, indices) -> list:
        """SSZ single-proofs for the GLOBAL leaf chunks `indices`: one
        gather of stored paths (K6 on CUDA) per touched shard, on its
        device; the siblings above the shards come from the host's top
        fold, then the zero ladder and the length chunk."""
        indices = [int(i) for i in indices]
        if not indices:
            return []
        if min(indices) < 0 or max(indices) >= self.n_chunks:
            raise ValueError("proof index outside the list's chunks")
        by_shard: dict = {}
        for i in indices:
            by_shard.setdefault(i >> self.local_depth, []).append(i)
        top = _top_tree_levels(self._shard_roots())
        zero_tail = list(ZERO_HASHES[self.data_depth:self.limit_depth])
        len_chunk = _length_chunk(self.length)
        proofs = {}
        for s, idxs in sorted(by_shard.items()):
            local = torch.zeros(_bucket(len(idxs)), dtype=torch.int64)
            local[:len(idxs)] = torch.tensor(
                [i & (self.shard_capacity - 1) for i in idxs])
            dev = self.devices[s]
            with on(dev):
                leaves, paths = gather_proof_paths(
                    self.shard_layers[s], local.to(dev), self.local_depth)
            leaves, paths = to_numpy_u32(leaves), to_numpy_u32(paths)
            for row, g in enumerate(idxs):
                branch = [_words_to_bytes(paths[row, lvl])
                          for lvl in range(self.local_depth)]
                branch += [top[lvl][(s >> lvl) ^ 1]
                           for lvl in range(self.shard_depth)]
                branch += zero_tail + [len_chunk]
                proofs[g] = SSZProof(index=g,
                                     gindex=(2 << self.limit_depth) + g,
                                     leaf=_words_to_bytes(leaves[row]),
                                     branch=tuple(branch))
        return [proofs[i] for i in indices]


def sharded_balances_forest(balances, length, limit_depth: int = 38,
                            n_shards: int | None = None, device_ids=None,
                            devices=None) -> ShardedMerkleForest:
    """A sharded forest over `List[uint64, 2**40]` from (N,) balances
    (numpy uint64 or an int64 tensor), packed 4 to a chunk (JAX `:713`)."""
    bal = _as_u64(balances, balances.device if isinstance(
        balances, torch.Tensor) else "cpu")
    return ShardedMerkleForest(pack_u64_chunks(bal), limit_depth, length,
                               n_shards=n_shards, device_ids=device_ids,
                               devices=devices)
