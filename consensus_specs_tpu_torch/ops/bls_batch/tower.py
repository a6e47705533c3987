"""Fq2/Fq6/Fq12 tower arithmetic on 12-bit-limb Fq tensors (counterpart
of `consensus_specs_tpu.ops.bls_batch.tower`): the plain PyTorch versions.

The same stacked-Karatsuba form as JAX: every multiplication level is ONE
stacked `fq_mul` call (an Fq12 product is one 33-step Montgomery loop
over an 18x-wider batch), so the limbs equal JAX's.

Representations (batch-first, int32):
    Fq2  : (..., 2, 33)
    Fq6  : (..., 3, 2, 33)
    Fq12 : (..., 2, 3, 2, 33)
"""

from __future__ import annotations

import numpy as np
import torch

from ..bls import fields as _f
from .fq import (N_LIMBS, const, fq_add, fq_canon, fq_inv, fq_mul,
                 fq_mul_small, fq_neg, fq_sub, from_mont, to_mont)

# --- host conversions -------------------------------------------------------


def fq2_from_oracle(a: _f.Fq2) -> np.ndarray:
    return np.stack([to_mont(a.c0), to_mont(a.c1)])


def fq6_from_oracle(a: _f.Fq6) -> np.ndarray:
    return np.stack([fq2_from_oracle(a.c0), fq2_from_oracle(a.c1),
                     fq2_from_oracle(a.c2)])


def fq12_from_oracle(a: _f.Fq12) -> np.ndarray:
    return np.stack([fq6_from_oracle(a.c0), fq6_from_oracle(a.c1)])


def _np(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def fq2_to_oracle(a) -> _f.Fq2:
    a = _np(a).reshape(2, N_LIMBS)
    return _f.Fq2(from_mont(a[0]), from_mont(a[1]))


def fq6_to_oracle(a) -> _f.Fq6:
    a = _np(a).reshape(3, 2, N_LIMBS)
    return _f.Fq6(*(fq2_to_oracle(c) for c in a))


def fq12_to_oracle(a) -> _f.Fq12:
    a = _np(a).reshape(2, 3, 2, N_LIMBS)
    return _f.Fq12(*(fq6_to_oracle(c) for c in a))


FQ2_ONE_L = fq2_from_oracle(_f.FQ2_ONE)
FQ12_ONE_L = fq12_from_oracle(_f.FQ12_ONE)
GAMMA_L = np.stack([fq2_from_oracle(g) for g in _f._GAMMA])

# --- Fq2 --------------------------------------------------------------------


def fq2_add(a, b):
    return fq_add(a, b)


def fq2_sub(a, b):
    return fq_sub(a, b)


def fq2_neg(a):
    return fq_neg(a)


def fq2_conj(a):
    return torch.stack([a[..., 0, :], fq_neg(a[..., 1, :])], dim=-2)


def fq2_mul(a, b):
    """Karatsuba: one stacked fq_mul of 3 products."""
    a0, a1 = a[..., 0, :], a[..., 1, :]
    b0, b1 = b[..., 0, :], b[..., 1, :]
    t = fq_mul(torch.stack([a0, a1, fq_add(a0, a1)]),
               torch.stack([b0, b1, fq_add(b0, b1)]))
    t0, t1, t2 = t[0], t[1], t[2]
    return torch.stack([fq_sub(t0, t1), fq_sub(t2, fq_add(t0, t1))], dim=-2)


def fq2_sqr(a):
    """(a+b)(a-b) + 2ab u: one stacked fq_mul of 2 products."""
    a0, a1 = a[..., 0, :], a[..., 1, :]
    t = fq_mul(torch.stack([fq_add(a0, a1), a0]),
               torch.stack([fq_sub(a0, a1), a1]))
    return torch.stack([t[0], fq_mul_small(t[1], 2)], dim=-2)


def fq2_mul_fq(a, s):
    """Fq2 * Fq scalar (s: (..., 33))."""
    return fq_mul(a, s[..., None, :])


def fq2_mul_small(a, k: int):
    return fq_mul_small(a, k)


def fq2_mul_xi(a):
    """* (1 + u):  (c0 - c1, c0 + c1)."""
    a0, a1 = a[..., 0, :], a[..., 1, :]
    return torch.stack([fq_sub(a0, a1), fq_add(a0, a1)], dim=-2)


def fq2_inv(a):
    """Norm-based inverse; 0 maps to 0 (RFC 9380 inv0 semantics)."""
    a0, a1 = a[..., 0, :], a[..., 1, :]
    t = fq_mul(torch.stack([a0, a1]), torch.stack([a0, a1]))
    d = fq_inv(fq_add(t[0], t[1]))
    out = fq_mul(torch.stack([a0, fq_neg(a1)]), d[None])
    return torch.movedim(out, 0, -2)


def fq2_is_zero(a):
    return (fq_canon(a) == 0).all(dim=-1).all(dim=-1)


def fq2_eq(a, b):
    return (fq_canon(a) == fq_canon(b)).all(dim=-1).all(dim=-1)


# --- Fq6 --------------------------------------------------------------------


def fq6_add(a, b):
    return fq_add(a, b)


def fq6_sub(a, b):
    return fq_sub(a, b)


def fq6_mul(a, b):
    """Toom/Karatsuba (oracle formula): 6 fq2 products in one stacked call."""
    a0, a1, a2 = a[..., 0, :, :], a[..., 1, :, :], a[..., 2, :, :]
    b0, b1, b2 = b[..., 0, :, :], b[..., 1, :, :], b[..., 2, :, :]
    pa = torch.stack([a0, a1, a2, fq_add(a1, a2), fq_add(a0, a1),
                      fq_add(a0, a2)])
    pb = torch.stack([b0, b1, b2, fq_add(b1, b2), fq_add(b0, b1),
                      fq_add(b0, b2)])
    t0, t1, t2, s12, s01, s02 = fq2_mul(pa, pb).unbind(0)
    c0 = fq_add(t0, fq2_mul_xi(fq_sub(s12, fq_add(t1, t2))))
    c1 = fq_add(fq_sub(s01, fq_add(t0, t1)), fq2_mul_xi(t2))
    c2 = fq_add(fq_sub(s02, fq_add(t0, t2)), t1)
    return torch.stack([c0, c1, c2], dim=-3)


def fq6_mul_by_v(a):
    """v * (a + bv + cv^2) = c*xi + a v + b v^2."""
    return torch.stack([fq2_mul_xi(a[..., 2, :, :]), a[..., 0, :, :],
                        a[..., 1, :, :]], dim=-3)


def fq6_neg(a):
    return fq_neg(a)


def fq6_inv(a):
    """Oracle formula: t0 = a0^2 - a1*a2*xi, etc., then one fq2 inverse."""
    a0, a1, a2 = a[..., 0, :, :], a[..., 1, :, :], a[..., 2, :, :]
    a0s, a2s, a1s, bc, ab = fq2_mul(torch.stack([a0, a2, a1, a1, a0]),
                                    torch.stack([a0, a2, a1, a2, a1])
                                    ).unbind(0)
    ac = fq2_mul(a0, a2)
    t0 = fq2_sub(a0s, fq2_mul_xi(bc))
    t1 = fq2_sub(fq2_mul_xi(a2s), ab)
    t2 = fq2_sub(a1s, ac)
    inner = fq2_mul(torch.stack([a0, a2, a1]), torch.stack([t0, t1, t2]))
    d = fq2_inv(fq2_add(inner[0],
                        fq2_mul_xi(fq2_add(inner[1], inner[2]))))
    out = fq2_mul(torch.stack([t0, t1, t2]), d[None])
    return torch.movedim(out, 0, -3)


# --- Fq12 -------------------------------------------------------------------


def fq12_mul(a, b):
    """Karatsuba over Fq6: 3 fq6 products in one stacked call (one 54-wide
    fq_mul)."""
    a0, a1 = a[..., 0, :, :, :], a[..., 1, :, :, :]
    b0, b1 = b[..., 0, :, :, :], b[..., 1, :, :, :]
    t0, t1, t2 = fq6_mul(torch.stack([a0, a1, fq_add(a0, a1)]),
                         torch.stack([b0, b1, fq_add(b0, b1)])).unbind(0)
    c0 = fq6_add(t0, fq6_mul_by_v(t1))
    c1 = fq6_sub(t2, fq_add(t0, t1))
    return torch.stack([c0, c1], dim=-4)


def fq12_sqr(a):
    """Oracle's complex squaring: 2 fq6 products."""
    a0, a1 = a[..., 0, :, :, :], a[..., 1, :, :, :]
    t0, s = fq6_mul(torch.stack([a0, fq_add(a0, a1)]),
                    torch.stack([a1, fq_add(a0, fq6_mul_by_v(a1))])
                    ).unbind(0)
    c0 = fq6_sub(s, fq6_add(t0, fq6_mul_by_v(t0)))
    c1 = fq_add(t0, t0)
    return torch.stack([c0, c1], dim=-4)


def fq12_conj(a):
    return torch.stack([a[..., 0, :, :, :], fq6_neg(a[..., 1, :, :, :])],
                       dim=-4)


def fq12_inv(a):
    a0, a1 = a[..., 0, :, :, :], a[..., 1, :, :, :]
    t = fq6_mul(torch.stack([a0, a1]), torch.stack([a0, a1]))
    d = fq6_inv(fq6_sub(t[0], fq6_mul_by_v(t[1])))
    out = fq6_mul(torch.stack([a0, fq6_neg(a1)]), d[None])
    return torch.movedim(out, 0, -4)


def fq12_eq(a, b):
    return (fq_canon(a) == fq_canon(b)).flatten(-4).all(dim=-1)


def fq12_is_one(a):
    return fq12_eq(a, const(FQ12_ONE_L, a.device).expand(a.shape))


def _w_coeffs(a):
    """Fq12 -> list of 6 Fq2 coefficients in w-power order (w^0..w^5)."""
    c0, c1 = a[..., 0, :, :, :], a[..., 1, :, :, :]
    return [c0[..., 0, :, :], c1[..., 0, :, :], c0[..., 1, :, :],
            c1[..., 1, :, :], c0[..., 2, :, :], c1[..., 2, :, :]]


def _from_w_coeffs(coeffs):
    c0 = torch.stack([coeffs[0], coeffs[2], coeffs[4]], dim=-3)
    c1 = torch.stack([coeffs[1], coeffs[3], coeffs[5]], dim=-3)
    return torch.stack([c0, c1], dim=-4)


def fq12_frobenius(a, power: int = 1):
    """x -> x^(q^power): conjugate the Fq2 coefficients and scale the w^i
    basis by gamma_i, `power` times, like the oracle."""
    for _ in range(power % 12):
        coeffs = _w_coeffs(a)
        stacked = torch.stack([fq2_conj(c) for c in coeffs])
        gammas = torch.stack(
            [const(GAMMA_L[i], a.device).expand(coeffs[i].shape)
             for i in range(6)])
        a = _from_w_coeffs(list(fq2_mul(stacked, gammas).unbind(0)))
    return a
