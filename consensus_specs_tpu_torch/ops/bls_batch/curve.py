"""Batched Jacobian point arithmetic on G1/G2 (counterpart of
`consensus_specs_tpu.ops.bls_batch.curve_jax`): the plain PyTorch versions.

Generic over the coordinate field (Fq for G1, Fq2 for G2) through a small
field-ops namespace, and branchless like JAX: the infinity, doubling and
cancellation cases of `pt_add` resolve with masked selects.  The formulas
and the order of their field operations are JAX's, so every coordinate
equals JAX's limb for limb; products that do not depend on one another
go through one stacked multiplication call (elementwise, so the limbs do
not change), which keeps the number of 33-step Montgomery loops down.
`pt_add` computes the doubling arm only when some lane takes it.

Points are (X, Y, Z) tuples of limb tensors; Z == 0 encodes infinity.
The kernels K8, K9 (`csrc/bls_rlc.cu`), K11 (`csrc/bls_h2c.cu`), K13
and K14 (`csrc/bls_msm.cu`) run the same formulas.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from ..bls import curve as _pycurve
from . import fq as _fq
from . import tower as _tw


@dataclass(frozen=True)
class FieldOps:
    name: str
    add: Callable
    sub: Callable
    mul: Callable
    sqr: Callable
    neg: Callable
    mul_small: Callable
    is_zero: Callable          # exact (canonicalizing) zero test -> (...)
    one: Any                   # numpy constant, element shape
    zero: Any
    elem_dims: int             # trailing dims of one element

    def expand(self, mask):
        return mask[(...,) + (None,) * self.elem_dims]


F1 = FieldOps(
    name="fq", add=_fq.fq_add, sub=_fq.fq_sub, mul=_fq.fq_mul,
    sqr=_fq.fq_sqr, neg=_fq.fq_neg, mul_small=_fq.fq_mul_small,
    is_zero=_fq.fq_is_zero, one=_fq.ONE_MONT,
    zero=np.zeros(_fq.N_LIMBS, dtype=np.int32), elem_dims=1)

F2 = FieldOps(
    name="fq2", add=_tw.fq2_add, sub=_tw.fq2_sub, mul=_tw.fq2_mul,
    sqr=_tw.fq2_sqr, neg=_tw.fq2_neg, mul_small=_tw.fq2_mul_small,
    is_zero=_tw.fq2_is_zero, one=_tw.FQ2_ONE_L,
    zero=np.zeros((2, _fq.N_LIMBS), dtype=np.int32), elem_dims=2)


def _muls(F: FieldOps, pairs):
    """Independent products in one stacked call."""
    return F.mul(torch.stack([a for a, _ in pairs]),
                 torch.stack([b for _, b in pairs])).unbind(0)


def _sqrs(F: FieldOps, xs):
    return F.sqr(torch.stack(xs)).unbind(0)


def pt_infinity(F: FieldOps, like):
    one = _fq.const(F.one, like[0].device).expand(like[0].shape)
    return (one, one, torch.zeros_like(like[0]))


def pt_select(F: FieldOps, mask, p, q):
    m = F.expand(mask)
    return tuple(torch.where(m, a, b) for a, b in zip(p, q))


def pt_double(F: FieldOps, p):
    """dbl-2007-bl (JAX `curve_jax.py:95`); Z=0 and Y=0 both land on
    Z3=0, so infinity needs no special-casing."""
    X, Y, Z = p
    A, B = _sqrs(F, [X, Y])
    E = F.mul_small(A, 3)
    C, XB2, Fv = _sqrs(F, [B, F.add(X, B), E])
    t = F.sub(XB2, F.add(A, C))
    D = F.add(t, t)
    X3 = F.sub(Fv, F.add(D, D))
    eight_c = F.mul_small(C, 8)
    ED, Z3 = _muls(F, [(E, F.sub(D, X3)), (F.add(Y, Y), Z)])
    Y3 = F.sub(ED, eight_c)
    return (X3, Y3, Z3)


def pt_add(F: FieldOps, p, q):
    """add-2007-bl with masked resolution of the special cases (JAX
    `curve_jax.py:113`): equal inputs double, opposite inputs give
    infinity, an infinite input gives the other."""
    X1, Y1, Z1, X2, Y2, Z2 = torch.broadcast_tensors(*p, *q)
    p, q = (X1, Y1, Z1), (X2, Y2, Z2)
    Z1Z1, Z2Z2 = _sqrs(F, [Z1, Z2])
    Z12 = F.add(Z1, Z2)
    U1, U2, Z2c, Z1c, Z12s = _muls(F, [(X1, Z2Z2), (X2, Z1Z1), (Z2Z2, Z2),
                                       (Z1Z1, Z1), (Z12, Z12)])
    S1, S2 = _muls(F, [(Y1, Z2c), (Y2, Z1c)])
    H = F.sub(U2, U1)
    rr = F.sub(S2, S1)
    rr2 = F.add(rr, rr)
    I, rr2s = _sqrs(F, [F.add(H, H), rr2])
    J, V, Z3, Z1H, Z2H = _muls(F, [(H, I), (U1, I), (Z12s, H), (Z1Z1, H),
                                   (Z2Z2, H)])
    X3 = F.sub(F.sub(rr2s, J), F.add(V, V))
    SJ, RV = _muls(F, [(S1, J), (rr2, F.sub(V, X3))])
    Y3 = F.sub(RV, F.add(SJ, SJ))
    Z3 = F.sub(F.sub(Z3, Z1H), Z2H)
    out = (X3, Y3, Z3)

    h_zero, r_zero, p_inf, q_inf = F.is_zero(
        torch.stack([H, rr, Z1, Z2])).unbind(0)
    # same x, same y -> doubling; same x, different y -> infinity
    dbl = h_zero & r_zero
    if dbl.any():
        out = pt_select(F, dbl, pt_double(F, p), out)
    out = pt_select(F, h_zero & ~r_zero, pt_infinity(F, p), out)
    out = pt_select(F, p_inf, q, out)
    out = pt_select(F, q_inf, p, out)
    return out


def pt_scalar_mul(F: FieldOps, p, scalar_bits: torch.Tensor):
    """Batched double-and-add, MSB first (JAX `curve_jax.py:147`).
    scalar_bits: int32 (..., nbits) per batch element; the add is always
    computed and masked in (bits differ across the batch)."""
    acc = pt_infinity(F, p)
    for bit in scalar_bits.to(torch.bool).unbind(-1):
        acc = pt_double(F, acc)
        acc = pt_select(F, bit, pt_add(F, acc, p), acc)
    return acc


def pt_scalar_mul_const(F: FieldOps, p, bits_np):
    """Double-and-add by ONE fixed host-known scalar (MSB-first bit
    array) for the whole batch, the cofactor-clearing shape (JAX
    `curve_jax.py:168`): the add runs only on set bits."""
    acc = pt_infinity(F, p)
    for bit in np.asarray(bits_np).tolist():
        acc = pt_double(F, acc)
        if bit:
            acc = pt_add(F, acc, p)
    return acc


def pt_msm_pippenger(F: FieldOps, p, digits: torch.Tensor, c: int):
    """Bucketed (Pippenger) multiscalar multiplication over the batch
    (JAX `curve_jax.py:188`).  p: (x, y, one) with B leading rows;
    digits: (B, W) int32 window digits, most significant window first
    (`scalars_to_digits`).  The points scatter in order into their bucket
    of every window at once, each window's 2^c buckets reduce by the
    suffix sum (bucket 0 never read), and the windows combine MSB-first
    with c doublings each.  Returns one Jacobian point."""
    B, W = digits.shape
    nb = 1 << c
    elem = p[0].shape[1:]
    dev = p[0].device
    one = _fq.const(F.one, dev).expand((W, nb) + elem)
    buckets = [one.clone(), one.clone(),
               torch.zeros((W, nb) + elem, dtype=torch.int32, device=dev)]
    widx = torch.arange(W, device=dev)
    for i in range(B):
        d = digits[i].long()
        cur = tuple(b[widx, d] for b in buckets)
        pt = tuple(co[i].expand((W,) + elem) for co in p)
        for b, nc in zip(buckets, pt_add(F, cur, pt)):
            b[widx, d] = nc
    # suffix sum over k = nb-1 .. 1, W windows wide
    running = acc = pt_infinity(F, tuple(b[:, 0] for b in buckets))
    for k in range(nb - 1, 0, -1):
        running = pt_add(F, running, tuple(b[:, k] for b in buckets))
        acc = pt_add(F, acc, running)
    res = pt_infinity(F, tuple(a[:1] for a in acc))
    for w in range(W):
        for _ in range(c):
            res = pt_double(F, res)
        res = pt_add(F, res, tuple(a[w:w + 1] for a in acc))
    return tuple(co[0] for co in res)


def pt_sum(F: FieldOps, p, n: int):
    """Sum a batch of n points (leading axis) with a log-depth add tree
    (JAX `curve_jax.py:252`): the first half plus the second, halving."""
    m = 1
    while m < n:
        m *= 2
    if m != n:
        pad = pt_infinity(F, tuple(c[:1] for c in p))
        p = tuple(torch.cat([c, pc.expand((m - n,) + c.shape[1:])])
                  for c, pc in zip(p, pad))
    while m > 1:
        m //= 2
        p = pt_add(F, tuple(c[:m] for c in p), tuple(c[m:2 * m] for c in p))
    return tuple(c[0] for c in p)


# --- host conversions -------------------------------------------------------


def scalars_to_bits(scalars, nbits: int) -> np.ndarray:
    """Python ints -> (B, nbits) int32 bit matrix, MSB first."""
    out = np.zeros((len(scalars), nbits), dtype=np.int32)
    for i, s in enumerate(scalars):
        s = int(s)
        assert 0 <= s < (1 << nbits)
        for j in range(nbits):
            out[i, nbits - 1 - j] = (s >> j) & 1
    return out


def scalars_to_digits(scalars, nbits: int, c: int) -> np.ndarray:
    """Python ints -> (B, ceil(nbits/c)) int32 c-bit window digits,
    most-significant window first (Pippenger layout)."""
    n_windows = -(-nbits // c)
    out = np.zeros((len(scalars), n_windows), dtype=np.int32)
    m = (1 << c) - 1
    for i, s in enumerate(scalars):
        s = int(s)
        assert 0 <= s < (1 << nbits)
        for w in range(n_windows):
            out[i, n_windows - 1 - w] = (s >> (c * w)) & m
    return out


def g1_affine_to_limbs(points) -> tuple[np.ndarray, np.ndarray]:
    """Oracle G1 Jacobian points -> (x, y) Montgomery limb stacks.
    Points must not be at infinity (filter on host first)."""
    xs, ys = [], []
    for p in points:
        aff = _pycurve.g1.to_affine(p)
        assert aff is not None, "infinity must be filtered host-side"
        xs.append(_fq.to_mont(aff[0]))
        ys.append(_fq.to_mont(aff[1]))
    return np.stack(xs), np.stack(ys)


def g2_affine_to_limbs(points) -> tuple[np.ndarray, np.ndarray]:
    xs, ys = [], []
    for p in points:
        aff = _pycurve.g2.to_affine(p)
        assert aff is not None, "infinity must be filtered host-side"
        xs.append(_tw.fq2_from_oracle(aff[0]))
        ys.append(_tw.fq2_from_oracle(aff[1]))
    return np.stack(xs), np.stack(ys)


def g1_limbs_to_oracle(p):
    """Device Jacobian G1 point (single element) -> oracle tuple."""
    return tuple(_fq.from_mont(_tw._np(c).reshape(_fq.N_LIMBS)) for c in p)


def g2_limbs_to_oracle(p):
    return tuple(_tw.fq2_to_oracle(c) for c in p)
