"""Batched SHA-256 of 64-byte messages (counterpart of
`consensus_specs_tpu.ops.sha256_jax`), with kernel K2.

Layout as in the JAX package: a message is 16 big-endian uint32 words,
a digest 8, carried here as int32 bit patterns (`_uint`).  Each message
is one Merkle parent: SHA-256 of the data block, then of the fixed
padding block of a 64-byte message.

`sha256_64B_words` runs the plain PyTorch version for a CPU tensor and
launches K2 (`csrc/sha256.cu`) for a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib

import numpy as np
import torch

from .. import _build
from .._uint import U32_MASK, add32, i32_to_u32, u32_to_i32

# fmt: off
_K = (
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2)
# fmt: on

_IV = (0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
       0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19)

# padding block of a 64-byte message: 0x80, zeros, bit length 512
_PAD64 = (0x80000000,) + (0,) * 14 + (512,)


def _zero_hash_words(max_depth: int = 65) -> np.ndarray:
    """(max_depth, 8) uint32: row d is the root of a depth-d all-zero
    subtree, as big-endian words."""
    out = np.zeros((max_depth, 8), dtype=np.uint32)
    node = bytes(32)
    for d in range(1, max_depth):
        node = hashlib.sha256(node + node).digest()
        out[d] = np.frombuffer(node, dtype=">u4")
    return out


ZERO_HASH_WORDS = _zero_hash_words()


@functools.cache
def zero_hash_words(device) -> torch.Tensor:
    """`ZERO_HASH_WORDS` as an int32 tensor on `device` (made once)."""
    return torch.from_numpy(ZERO_HASH_WORDS.view(np.int32)).to(device)


# --- plain PyTorch version --------------------------------------------------


def _rotr3(x, r1, r2, r3=None):
    """rotr(x, r1) ^ rotr(x, r2) [^ rotr(x, r3)] of uint32 values in int64:
    with x copied into the high half, a rotation is one right shift."""
    x64 = x | (x << 32)
    y = (x64 >> r1) ^ (x64 >> r2)
    if r3 is not None:
        y = y ^ (x64 >> r3)
    return y & U32_MASK


def _compress(state, block):
    """One compression over a batch.  `state` and `block` are lists of 8
    and 16 lanes; a lane is an int64 tensor of uint32 values, or a Python
    int when it is the same for every message (the IV, the padding block),
    so the padding block's message schedule is computed once, on the host.
    Ch and Maj use the usual 3- and 4-operation identities."""
    w = list(block)
    a, b, c, d, e, f, g, h = state
    for t in range(64):
        if t >= 16:
            w15, w2 = w[t - 15], w[t - 2]
            s0 = _rotr3(w15, 7, 18) ^ (w15 >> 3)
            s1 = _rotr3(w2, 17, 19) ^ (w2 >> 10)
            w.append((w[t - 16] + s0 + w[t - 7] + s1) & U32_MASK)
            w[t - 16] = None             # last use: free it
        ch = g ^ (e & (f ^ g))
        t1 = h + _rotr3(e, 6, 11, 25) + ch + (_K[t] + w[t])
        maj = (a & b) | (c & (a | b))
        h, g, f, e, d, c, b, a = (g, f, e, add32(d, t1), c, b, a,
                                  add32(t1, _rotr3(a, 2, 13, 22) + maj))
    return [add32(s, v) for s, v in zip(state, (a, b, c, d, e, f, g, h))]


def sha256_64B_words_plain(blocks: torch.Tensor) -> torch.Tensor:
    """SHA-256 of (..., 16) int32 message words -> (..., 8) digest words,
    in plain PyTorch on the tensor's own device."""
    if blocks.shape[-1] != 16:
        raise ValueError(f"expected (..., 16) words, got {tuple(blocks.shape)}")
    x = i32_to_u32(blocks.reshape(-1, 16))
    state = _compress(list(_IV), [x[:, i] for i in range(16)])
    state = _compress(state, list(_PAD64))
    out = torch.stack(state, dim=-1)
    return u32_to_i32(out).reshape(blocks.shape[:-1] + (8,))


# --- kernel K2 ----------------------------------------------------------------


@functools.cache
def _lib():
    lib = _build.load("sha256")
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.sha256_64B_launch.argtypes = [p, p, i64, p]
    lib.sha256_u64_leaves_launch.argtypes = [p, p, i64, i64, p]
    lib.sha256_64B_launch.restype = ctypes.c_int
    lib.sha256_u64_leaves_launch.restype = ctypes.c_int
    return lib


def _out_words(blocks: torch.Tensor, out) -> torch.Tensor:
    """The (..., 8) int32 digest tensor for `blocks`: `out` when given
    (checked), else a new one."""
    shape = blocks.shape[:-1] + (8,)
    if out is None:
        return torch.empty(shape, dtype=torch.int32, device=blocks.device)
    if (out.shape != shape or out.dtype != torch.int32
            or out.device != blocks.device or not out.is_contiguous()):
        raise ValueError(f"sha256_64B: out must be a contiguous {tuple(shape)}"
                         f" int32 tensor on {blocks.device}")
    return out


def sha256_64B_words_kernel(blocks: torch.Tensor, out=None) -> torch.Tensor:
    """K2 on a CUDA tensor of (..., 16) int32 message words; writes the
    digests into `out` (a contiguous (..., 8) int32 tensor, e.g. one
    level of a Merkle forest) when given."""
    if blocks.dtype != torch.int32 or blocks.shape[-1] != 16:
        raise ValueError("sha256_64B: expected (..., 16) int32 words, got "
                         f"{blocks.dtype} {tuple(blocks.shape)}")
    out = _out_words(blocks, out)
    _build.require_cuda("sha256_64B", blocks, out)
    n = blocks.numel() // 16
    if n:
        _build.check(_lib().sha256_64B_launch(
            blocks.data_ptr(), out.data_ptr(), n, _build.stream_ptr(blocks)),
            "sha256_64B")
        _build.launches["sha256_64B"] += 1
    return out


def sha256_u64_leaves_kernel(values: torch.Tensor) -> torch.Tensor:
    """K2 in leaf mode: message i is the two 32-byte SSZ chunks that pack
    the uint64 values 8i .. 8i+7 (zero past the end of `values`).
    (N,) int64 on CUDA -> (ceil(N / 8), 8) int32 digest words."""
    _build.require_cuda("sha256_64B", values)
    if values.dtype != torch.int64 or values.dim() != 1:
        raise ValueError("sha256_u64_leaves: expected (N,) int64, got "
                         f"{values.dtype} {tuple(values.shape)}")
    n_vals = values.shape[0]
    n_msgs = -(-n_vals // 8)
    out = torch.empty((n_msgs, 8), dtype=torch.int32, device=values.device)
    if n_msgs:
        _build.check(_lib().sha256_u64_leaves_launch(
            values.data_ptr(), out.data_ptr(), n_msgs, n_vals,
            _build.stream_ptr(values)), "sha256_u64_leaves")
        _build.launches["sha256_64B"] += 1
    return out


def sha256_64B_words(blocks: torch.Tensor, out=None) -> torch.Tensor:
    """SHA-256 of (..., 16)-word 64-byte messages -> (..., 8)-word digests:
    the plain version for a CPU tensor, K2 for a CUDA tensor.  With
    `out`, the digests are written there and `out` is returned."""
    if blocks.device.type != "cpu":
        return sha256_64B_words_kernel(blocks, out)
    digests = sha256_64B_words_plain(blocks)
    return digests if out is None else _out_words(blocks, out).copy_(digests)


def hash_pairs(words: torch.Tensor) -> torch.Tensor:
    """One Merkle level: (2N, 8) chunk words -> (N, 8) parent words."""
    return sha256_64B_words(words.reshape(-1, 16))
