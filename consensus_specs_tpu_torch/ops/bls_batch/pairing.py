"""Batched optimal-ate pairing (counterpart of
`consensus_specs_tpu.ops.bls_batch.pairing_jax`): the plain PyTorch
versions of the shared-accumulator Miller product and the final
exponentiation.

The Miller loop runs on the sextic twist in Fq2 with Jacobian T and
inversion-free line coefficients; all B pairings advance in lockstep
through the 63 bits of |x| below its leading one and share ONE Fq12
accumulator, F <- F^2 * prod_b line_b (JAX's docstring derives it).  A
line differs from the oracle's Miller-loop line by an Fq2 factor, which
the final exponentiation kills, so a Miller value compares with JAX's
`miller_product_batch` only, never with the oracle's Miller loop.

The final exponentiation uses the x-structured hard part,
3·(q⁴−q²+1)/r = (x−1)²·(x+q)·(x²+q²−1) + 3, so it yields the CUBE of the
standard pairing value: compare with JAX, or with the oracle's
`final_exponentiate(...)**3`.

For a G2 argument known on the host (every `pairing_check_device` call),
`precompute_g2_lines` runs the T-update schedule once per point in oracle
Fq2 arithmetic and `miller_product_precomp` only evaluates the lines at
P: no G2 arithmetic on the device.

The kernels K9 (`rlc_miller_product`) and K10 (`final_exp_is_one`) in
`csrc/bls_rlc.cu`, and K12 (`precomp_miller_product`, `csrc/bls_pairing.cu`)
compute the same values.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..bls import curve as _pycurve
from ..bls import pairing as _pyp
from ..bls.fields import BLS_X, Q, R, Fq2
from . import curve as C
from . import tower as tw
from .fq import const

assert 3 * ((Q**4 - Q**2 + 1) // R) == \
    (BLS_X - 1) ** 2 * (BLS_X + Q) * (BLS_X**2 + Q**2 - 1) + 3

# |x| bits MSB-first, skipping the leading 1 (Miller loop schedule)
X_BITS = np.array([int(b) for b in bin(abs(BLS_X))[3:]], dtype=np.int32)
# |x| bits MSB-first including the leading 1 (final-exp pow_x schedule)
X_BITS_FULL = np.array([int(b) for b in bin(abs(BLS_X))[2:]], dtype=np.int32)


def _w_slot(e12) -> tuple[int, Fq2]:
    """Decompose an Fq12 that is a single w-power multiple: (index, coeff)."""
    coeffs = [e12.c0.c0, e12.c1.c0, e12.c0.c1, e12.c1.c1, e12.c0.c2,
              e12.c1.c2]
    nz = [(i, c) for i, c in enumerate(coeffs) if not c.is_zero()]
    assert len(nz) == 1, "untwist constant is not a pure w-power"
    return nz[0]


# untwist preimage of P scales: x_P·cx⁻¹, y_P·cy⁻¹ (slot index, Fq2 scale)
JX, SX = _w_slot(_pyp._fq2_to_fq12(Fq2(1, 0)) * _pyp._UNTWIST_CX.inv())
JY, SY = _w_slot(_pyp._fq2_to_fq12(Fq2(1, 0)) * _pyp._UNTWIST_CY.inv())
SX_L = tw.fq2_from_oracle(SX)
SY_L = tw.fq2_from_oracle(SY)


def _line_to_fq12(c0, cx_xp, cy_yp):
    """Place the three Fq2 line terms into their fixed w-power slots."""
    dev = c0.device
    sx, sy = tw.fq2_mul(torch.stack([cx_xp, cy_yp]), torch.stack(
        [const(SX_L, dev).expand(cx_xp.shape),
         const(SY_L, dev).expand(cy_yp.shape)])).unbind(0)
    zero = torch.zeros_like(c0)
    slots = [zero] * 6
    slots[0], slots[JX], slots[JY] = c0, sx, sy
    return tw._from_w_coeffs(slots)


def _eval_line(c0, cx, cy, xp, yp):
    cx_xp, cy_yp = tw.fq2_mul_fq(torch.stack([cx, cy]),
                                 torch.stack([xp, yp])).unbind(0)
    return _line_to_fq12(c0, cx_xp, cy_yp)


def _dbl_step(T, xp, yp):
    """Tangent-line coefficients at T, evaluated at P; then T <- 2T."""
    X, Y, Z = T
    XX, YY, ZZ = tw.fq2_sqr(torch.stack([X, Y, Z])).unbind(0)
    YZ, XXZZ, XXX = tw.fq2_mul(torch.stack([Y, XX, XX]),
                               torch.stack([Z, ZZ, X])).unbind(0)
    cy = tw.fq2_mul_small(tw.fq2_mul(YZ, ZZ), 2)                   # 2YZ^3
    cx = tw.fq2_neg(tw.fq2_mul_small(XXZZ, 3))                     # -3X^2Z^2
    c0 = tw.fq2_sub(tw.fq2_mul_small(XXX, 3),
                    tw.fq2_mul_small(YY, 2))                       # 3X^3-2Y^2
    return C.pt_double(C.F2, T), _eval_line(c0, cx, cy, xp, yp)


def _add_step(T, xq, yq, xp, yp):
    """Chord-line coefficients through T and affine Q; then T <- T + Q."""
    X, Y, Z = T
    ZZ = tw.fq2_sqr(Z)
    xqZZ, ZZZ = tw.fq2_mul(torch.stack([xq, ZZ]),
                           torch.stack([ZZ, Z])).unbind(0)
    H = tw.fq2_sub(X, xqZZ)
    I = tw.fq2_sub(Y, tw.fq2_mul(yq, ZZZ))
    ZH = tw.fq2_mul(Z, H)
    Ixq, ZHyq = tw.fq2_mul(torch.stack([I, ZH]),
                           torch.stack([xq, yq])).unbind(0)
    c0 = tw.fq2_sub(Ixq, ZHyq)
    line = _eval_line(c0, tw.fq2_neg(I), ZH, xp, yp)
    one = const(tw.FQ2_ONE_L, xq.device).expand(xq.shape)
    return C.pt_add(C.F2, T, (xq, yq, one)), line


def _product_tree(f, n: int):
    """Product over the leading batch axis: exactly n-1 Fq12 multiplies in
    ceil(log2 n) levels (odd level sizes carry their tail element)."""
    assert f.shape[0] == n and n >= 1
    while n > 1:
        half = n // 2
        prod = tw.fq12_mul(f[:half], f[half:2 * half])
        if n % 2:
            f = torch.cat([prod, f[2 * half:]])
            n = half + 1
        else:
            f, n = prod, half
    return f[0]


def miller_product_batch(xp, yp, xq, yq, mask):
    """prod_b f_{|x|,Q_b}(P_b)^(mask_b) with a SHARED Fq12 accumulator
    (JAX `pairing_jax.py:133`); masked-out lanes contribute the identity
    line every step.  Returns one Fq12 (conjugated; NOT final-
    exponentiated)."""
    B = xp.shape[0]
    dev = xp.device
    T = (xq, yq, const(tw.FQ2_ONE_L, dev).expand(xq.shape))
    f = const(tw.FQ12_ONE_L, dev)
    one_b = const(tw.FQ12_ONE_L, dev).expand((B,) + tw.FQ12_ONE_L.shape)
    mask_e = mask[:, None, None, None, None]
    for bit in X_BITS.tolist():
        f = tw.fq12_sqr(f)
        T, line = _dbl_step(T, xp, yp)
        f = tw.fq12_mul(f, _product_tree(torch.where(mask_e, line, one_b), B))
        if bit:
            T, line = _add_step(T, xq, yq, xp, yp)
            f = tw.fq12_mul(f, _product_tree(
                torch.where(mask_e, line, one_b), B))
    return tw.fq12_conj(f)       # negative BLS parameter


# --- fixed-argument (host-known G2) line precomputation ---------------------


def _host_line_coeffs_dbl(T):
    """Oracle-Fq2 tangent coefficients at Jacobian T (`_dbl_step`'s
    formula, on the host)."""
    X, Y, Z = T
    XX = X.square()
    YY = Y.square()
    ZZ = Z.square()
    cy = Y * Z * ZZ * 2
    cx = -(XX * ZZ * 3)
    c0 = XX * X * 3 - YY * 2
    return c0, cx, cy


def _host_line_coeffs_add(T, xq, yq):
    """Oracle-Fq2 chord coefficients through T and affine (xq, yq)."""
    X, Y, Z = T
    ZZ = Z.square()
    H = X - xq * ZZ
    I = Y - yq * ZZ * Z
    ZH = Z * H
    return I * xq - ZH * yq, -I, ZH


@functools.lru_cache(maxsize=64)
def _g2_lines_from_affine(x0: int, x1: int, y0: int, y1: int) -> np.ndarray:
    """Miller line coefficients for a fixed affine G2 point (JAX
    `pairing_jax.py:203`): one (n_bits, 6, 2, 33) int32 array of
    Montgomery Fq2 limbs, slots [dbl_c0, dbl_cx, dbl_cy, add_c0, add_cx,
    add_cy]; the add slots are identity filler on 0 bits."""
    xq, yq = Fq2(x0, x1), Fq2(y0, y1)
    T = _pycurve.g2.from_affine(xq, yq)
    rows = []
    filler = (Fq2(1, 0), Fq2(0, 0), Fq2(0, 0))
    for bit in X_BITS:
        dbl = _host_line_coeffs_dbl(T)
        T = _pycurve.g2.double(T)
        if bit:
            add = _host_line_coeffs_add(T, xq, yq)
            T = _pycurve.g2.add(T, _pycurve.g2.from_affine(xq, yq))
        else:
            add = filler
        rows.append(np.stack([tw.fq2_from_oracle(c) for c in dbl + add]))
    return np.stack(rows).astype(np.int32)


def precompute_g2_lines(q_pt) -> np.ndarray:
    """Host-side fixed-argument precompute for a (non-infinity) oracle
    Jacobian G2 point; cached per affine point."""
    aff = _pycurve.g2.to_affine(q_pt)
    assert aff is not None, "cannot precompute lines for infinity"
    x, y = aff
    return _g2_lines_from_affine(x.c0, x.c1, y.c0, y.c1)


def miller_product_precomp(xp, yp, lines, mask):
    """Shared-accumulator Miller product with host-precomputed lines (JAX
    `pairing_jax.py:234`): xp, yp (B, 33) G1 affine limbs, lines
    (n_bits, B, 6, 2, 33) from `precompute_g2_lines` stacked over the
    batch, mask (B,).  No G2 arithmetic: the line evaluation at P, the
    product tree and one accumulator square and product per step.
    Returns one Fq12 (conjugated; NOT final-exponentiated)."""
    B = xp.shape[0]
    dev = xp.device
    f = const(tw.FQ12_ONE_L, dev)
    one_b = const(tw.FQ12_ONE_L, dev).expand((B,) + tw.FQ12_ONE_L.shape)
    mask_e = mask[:, None, None, None, None]

    def line(c0, cx, cy):
        return torch.where(mask_e, _eval_line(c0, cx, cy, xp, yp), one_b)

    for k, bit in enumerate(X_BITS.tolist()):
        L = lines[k]
        f = tw.fq12_sqr(f)
        f = tw.fq12_mul(f, _product_tree(line(L[:, 0], L[:, 1], L[:, 2]), B))
        if bit:
            f = tw.fq12_mul(f, _product_tree(
                line(L[:, 3], L[:, 4], L[:, 5]), B))
    return tw.fq12_conj(f)


def fq12_pow_x_abs(g):
    """g^|x| via square-and-multiply over the fixed 64-bit parameter."""
    acc = const(tw.FQ12_ONE_L, g.device).expand(g.shape)
    for bit in X_BITS_FULL.tolist():
        acc = tw.fq12_sqr(acc)
        if bit:
            acc = tw.fq12_mul(acc, g)
    return acc


def final_exponentiate(f):
    """f^(3·(q^12-1)/r): x-structured hard part, cyclotomic inverses as
    conjugates (JAX `pairing_jax.py:297`)."""
    # easy part: f^((q^6-1)(q^2+1))
    f1 = tw.fq12_mul(tw.fq12_conj(f), tw.fq12_inv(f))
    m = tw.fq12_mul(tw.fq12_frobenius(f1, 2), f1)

    def pow_x(g):                      # g^x  (x negative)
        return tw.fq12_conj(fq12_pow_x_abs(g))

    def pow_xm1(g):                    # g^(x-1)
        return tw.fq12_mul(pow_x(g), tw.fq12_conj(g))

    t1 = pow_xm1(pow_xm1(m))                              # m^((x-1)^2)
    t2 = tw.fq12_mul(pow_x(t1), tw.fq12_frobenius(t1, 1))  # ^(x+q)
    t3 = tw.fq12_mul(
        tw.fq12_mul(pow_x(pow_x(t2)), tw.fq12_frobenius(t2, 2)),
        tw.fq12_conj(t2))                                 # ^(x^2+q^2-1)
    return tw.fq12_mul(t3, tw.fq12_mul(tw.fq12_sqr(m), m))  # · m^3


def multi_pairing_check_precomp(xp, yp, lines, mask):
    """`multi_pairing_check` with precomputed lines (JAX
    `pairing_jax.py:273`)."""
    total = miller_product_precomp(xp, yp, lines, mask)
    return tw.fq12_is_one(final_exponentiate(total))


def multi_pairing_check(xp, yp, xq, yq, mask):
    """prod_i e(P_i, Q_i)^(mask_i) == 1 with one final exponentiation
    (JAX `pairing_jax.py:335`)."""
    total = miller_product_batch(xp, yp, xq, yq, mask)
    return tw.fq12_is_one(final_exponentiate(total))
