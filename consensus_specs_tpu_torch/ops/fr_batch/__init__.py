"""Batched BLS12-381 scalar-field (Fr) work on the card (counterpart of
`consensus_specs_tpu.ops.fr_batch`): the KZG barycentric evaluation, the
DAS coset-interpolation fold and the field FFT.

The entry points take and return canonical Python ints, as JAX's
synchronous facades do, and run on `device` (CUDA by default;
`device="cpu"` runs the plain versions):

    barycentric_eval(poly, domain, z, shift=1)   f(z), evaluation form
    coset_interpolate_sum(evals, idft, weights)  the RLI coefficient fold
    fr_fft(rows, roots, inverse=False)           FFT / inverse FFT

Each device stage is a kernel on a CUDA tensor and its plain PyTorch
version on a CPU tensor (or with `plain=True`):

    field_op               K15  one Fr op elementwise
    batch_inverse          K15  Montgomery's batch inversion, one launch
    barycentric            K16  f(z) over a width-W domain h G
    coset_interpolate      K17  sum_b w[b, j] sum_i e[b, i] M[i, j]
    fft                    K18  radix-2 DIT FFT of bit-reversed rows

The plain stages compose exactly as JAX's programs (`_barycentric_kernel`,
`_coset_interpolate_kernel`, `_fr_fft_kernel`), so on the CPU every value
equals JAX's limb for limb; the kernels return canonical limbs, equal to
`FR.canon` of the plain ones.  No stage falls back to another route when
a kernel fails to build or launch.

The `*_async` forms and the telemetry and cost-model seams are not
ported yet.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ... import resolve_device
from . import kernels as K
from .field import FR, LIMB_BITS, N_LIMBS, R_MODULUS, das_rung  # noqa: F401


def _use_kernel(t: torch.Tensor, plain: bool) -> bool:
    return t.device.type == "cuda" and not plain


def _to(a: np.ndarray, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(dev)


def from_limbs(t: torch.Tensor) -> list[int]:
    """(..., 33) limbs (canonical or lazy) -> canonical ints, row-major."""
    arr = t.cpu().numpy().reshape(-1, N_LIMBS)
    if arr.size and arr.min() >= 0 and arr.max() <= 0xFFF:
        # canonical limbs: pack the 12-bit groups into bytes in numpy
        bits = (arr[:, :, None] >> np.arange(LIMB_BITS)) & 1
        bits = bits.reshape(len(arr), -1).astype(np.uint8)
        bits = np.concatenate(
            [bits, np.zeros((len(arr), 4), np.uint8)], axis=1)
        raw = np.packbits(bits, axis=1, bitorder="little")
        inv = pow(FR.r_mont, -1, R_MODULUS)
        return [int.from_bytes(row.tobytes(), "little") * inv % R_MODULUS
                for row in raw]
    return FR.from_mont_batch(arr)


# --- K15 ------------------------------------------------------------------

_PLAIN_OPS = {
    "mul": lambda a, b, e: FR.mul(a, b),
    "add": lambda a, b, e: FR.add(a, b),
    "sub": lambda a, b, e: FR.sub(a, b),
    "inv": lambda a, b, e: FR.inv(a),
    "pow": lambda a, b, e: FR.pow_uint(a, e),
    "canon": lambda a, b, e: a,
}


def field_op_plain(op: str, a, b=None, e: int = 0):
    """K15's plain version: the op in plain PyTorch, then `FR.canon`."""
    return FR.canon(_PLAIN_OPS[op](a, b, e))


def field_op(op: str, a, b=None, e: int = 0, plain: bool = False):
    """`op` elementwise with canonical output: K15 on a CUDA tensor, the
    plain version otherwise."""
    if _use_kernel(a, plain):
        return K.field_op_kernel(op, a, b, e)
    return field_op_plain(op, a, b, e)


def batch_inverse_plain(x):
    """K15 batch inverse's plain version: Montgomery's trick on (n, 33)
    limbs as a product tree over `field_op_plain`, log2 of n (padded with
    ones to a power of two) levels each way: the products up, one
    inversion of the root, then each level's inverses from its parents'.
    Canonical limbs; a zero element makes every output 0."""
    n = x.shape[0]
    m = 1 << (n - 1).bit_length()
    one = torch.from_numpy(FR.to_mont(1)).to(x.device)
    levels = [torch.cat([x, one.expand(m - n, N_LIMBS)])]
    while levels[-1].shape[0] > 1:
        t = levels[-1]
        levels.append(field_op_plain("mul", t[0::2], t[1::2]))
    inv = field_op_plain("inv", levels[-1])
    for lvl in reversed(levels[:-1]):
        k = inv.shape[0]
        both = field_op_plain("mul", torch.cat([inv, inv]),
                              torch.cat([lvl[1::2], lvl[0::2]]))
        inv = torch.stack([both[:k], both[k:]], dim=1).reshape(lvl.shape)
    return inv[:n]


def batch_inverse(x, plain: bool = False):
    """The inverses of the n elements of x (n, 33), canonical (all 0 if
    one is 0): K15's batch inverse in one launch on a CUDA tensor, the
    plain product tree otherwise."""
    if _use_kernel(x, plain):
        return K.batch_inverse_kernel(x)
    return batch_inverse_plain(x)


# --- K16 ------------------------------------------------------------------


def barycentric_plain(poly, roots, z, h_pow_w, inv_scale):
    """JAX `_barycentric_kernel`'s program: (33,) limbs, lazy."""
    width = poly.shape[0]
    a = FR.mul(poly, roots)                              # f_i * x_i
    b = FR.sub(z.expand(roots.shape), roots)             # z - x_i
    d = FR.inv(b)                                        # all lanes at once
    total = FR.tree_sum(FR.mul(a, d), width)             # value < W * 2p
    factor = FR.sub(FR.pow_uint(z, width), h_pow_w)
    return FR.mul(FR.mul(total, factor), inv_scale)


def barycentric(poly, roots, z, h_pow_w, inv_scale, plain=False):
    """f(z) = (z^W - h^W) / (W h^W) * sum_i f_i x_i / (z - x_i) over the
    domain `roots` (W, 33) (any order), z, h^W and 1 / (W h^W) as (33,)
    limbs.  K16 on a CUDA tensor (canonical), the plain version
    otherwise (JAX's limbs)."""
    if _use_kernel(poly, plain):
        return K.barycentric_kernel(poly, roots, z, h_pow_w, inv_scale)
    return barycentric_plain(poly, roots, z, h_pow_w, inv_scale)


@functools.lru_cache(maxsize=16)
def _mont_table(key: tuple) -> np.ndarray:
    return FR.to_mont_batch(list(key))


def barycentric_inputs(poly_ints, domain_ints, z_int, shift_int: int = 1):
    """The host side of `barycentric_eval` (JAX `:251-295`): numpy
    (poly, roots, z, h^W, 1 / (W h^W)) Montgomery limbs."""
    width = len(poly_ints)
    assert width == len(domain_ints)
    h = int(shift_int) % R_MODULUS
    assert h != 0
    h_pow_w = pow(h, width, R_MODULUS)
    inv_scale = pow(width * h_pow_w % R_MODULUS, R_MODULUS - 2, R_MODULUS)
    return (FR.to_mont_batch([int(v) for v in poly_ints]),
            _mont_table(tuple(int(r) for r in domain_ints)),
            FR.to_mont(int(z_int)), FR.to_mont(h_pow_w),
            FR.to_mont(inv_scale))


def barycentric_eval(poly_ints, domain_ints, z_int, shift_int: int = 1,
                     device="cuda") -> int:
    """The evaluation-form polynomial `poly_ints` over the domain
    `domain_ints` (the same order; any order works) at an out-of-domain
    z, as a canonical int; `shift_int=h` for a coset domain h G.  K16 on
    a CUDA `device`, the plain version on the CPU."""
    dev = resolve_device(device)
    args = tuple(_to(a, dev) for a in barycentric_inputs(
        poly_ints, domain_ints, z_int, shift_int))
    return from_limbs(barycentric(*args))[0]


# --- K17 ------------------------------------------------------------------


def coset_interpolate_plain(evals, idft, weights):
    """JAX `_coset_interpolate_kernel`'s program: (W, 33) limbs, lazy."""
    batch, width = evals.shape[0], evals.shape[1]
    acc = torch.zeros((batch, width, N_LIMBS), dtype=torch.int32,
                      device=evals.device)
    for i in range(width):
        acc = FR.add(acc, FR.mul(evals[:, i, None, :], idft[i][None]))
    return FR.tree_sum(FR.mul(acc, weights), batch)


def coset_interpolate(evals, idft, weights, plain=False):
    """S_j = sum_b weights[b, j] * sum_i evals[b, i] idft[i, j]: evals
    and weights (B, W, 33), idft (W, W, 33).  K17 on a CUDA tensor
    (canonical), the plain version otherwise (JAX's limbs)."""
    if _use_kernel(evals, plain):
        return K.coset_interpolate_kernel(evals, idft, weights)
    return coset_interpolate_plain(evals, idft, weights)


def coset_interpolate_inputs(evals_rows, idft_matrix, weight_rows):
    """The host side of `coset_interpolate_sum` (JAX `:396-433`): numpy
    (evals, idft, weights) Montgomery limbs, the batch padded to
    `das_rung(n)` with zero rows and zero weights."""
    n = len(evals_rows)
    assert n == len(weight_rows) and n >= 1
    width = len(idft_matrix)
    b = das_rung(n)
    flat = [int(v) for row in evals_rows for v in row]
    flat += [0] * ((b - n) * width)
    wflat = [int(v) for row in weight_rows for v in row]
    wflat += [0] * ((b - n) * width)        # zero weight = dead lane
    idft = _mont_table(tuple(int(v) for row in idft_matrix for v in row))
    return (FR.to_mont_batch(flat).reshape(b, width, N_LIMBS),
            idft.reshape(width, width, N_LIMBS),
            FR.to_mont_batch(wflat).reshape(b, width, N_LIMBS))


def coset_interpolate_sum(evals_rows, idft_matrix, weight_rows,
                          device="cuda") -> list[int]:
    """The `width` canonical ints S_j = sum_k weights[k][j] *
    (IDFT(evals[k]))_j: with weights r^k h_k^-j, the coefficients of
    sum_k r^k I_k(X) (`das.verify`).  K17 on a CUDA `device`, the plain
    version on the CPU."""
    dev = resolve_device(device)
    args = tuple(_to(a, dev) for a in coset_interpolate_inputs(
        evals_rows, idft_matrix, weight_rows))
    return from_limbs(coset_interpolate(*args))


# --- K18 ------------------------------------------------------------------


def fft_plain(x, roots, scale):
    """JAX `_fr_fft_kernel`'s program on x (batch, n, 33) in bit-reversed
    order; stage h multiplies lane i by roots[i n / (2h)]."""
    batch, n = x.shape[0], x.shape[1]
    h = 1
    while h < n:
        tw = roots[::n // (2 * h)][:h]
        blocks = x.reshape(batch, n // (2 * h), 2, h, N_LIMBS)
        u, v = blocks[:, :, 0], blocks[:, :, 1]
        t = FR.mul(v, tw[None, None])
        x = torch.stack([FR.add(u, t), FR.sub(u, t)],
                        dim=2).reshape(batch, n, N_LIMBS)
        h *= 2
    return FR.mul(x, scale[None, None])


def fft(x, roots, scale, plain=False):
    """The radix-2 DIT FFT of each bit-reversed row of x (batch, n, 33)
    over `roots` (n, 33), times `scale`: natural order out.  K18 on a
    CUDA tensor (canonical), the plain version otherwise (JAX's
    limbs)."""
    if _use_kernel(x, plain):
        return K.fft_kernel(x, roots, scale)
    return fft_plain(x, roots, scale)


@functools.lru_cache(maxsize=8)
def _bitrev_perm(n: int) -> tuple:
    bits = n.bit_length() - 1
    return tuple(int(f"{i:0{bits}b}"[::-1], 2) if bits else 0
                 for i in range(n))


def fft_inputs(rows, roots, inverse: bool = False):
    """The host side of `fr_fft` (JAX `:476-506`): numpy (x, roots,
    scale) limbs, x bit-reversed; the inverse runs the reversed roots
    (roots[0], roots[n-1], ..., roots[1]) and scales by 1 / n."""
    n = len(roots)
    assert n and n & (n - 1) == 0
    batch = len(rows)
    assert batch >= 1 and all(len(r) == n for r in rows)
    roots_key = tuple(int(r) % R_MODULUS for r in roots)
    if inverse:
        roots_key = (roots_key[0],) + roots_key[:0:-1]
        scale_int = pow(n, R_MODULUS - 2, R_MODULUS)
    else:
        scale_int = 1
    perm = _bitrev_perm(n)
    flat = [int(row[j]) for row in rows for j in perm]
    return (FR.to_mont_batch(flat).reshape(batch, n, N_LIMBS),
            _mont_table(roots_key), FR.to_mont(scale_int))


def fr_fft(rows, roots, inverse: bool = False, device="cuda"):
    """FFT of a batch of rows of ints over the domain `roots` (natural
    order in and out; `inverse=True` runs the reversed-root transform
    and scales by 1/n), as lists of canonical ints.  K18 on a CUDA
    `device`, the plain version on the CPU."""
    dev = resolve_device(device)
    x, r, s = (_to(a, dev) for a in fft_inputs(rows, roots, inverse))
    flat = from_limbs(fft(x, r, s))
    n = len(roots)
    return [flat[i * n:(i + 1) * n] for i in range(len(rows))]
