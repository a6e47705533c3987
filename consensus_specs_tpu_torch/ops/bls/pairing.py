"""Optimal ate pairing on BLS12-381.

G2 points are untwisted into E(Fq12) and the Miller loop runs entirely in
Fq12 (correctness-first oracle; the batched/TPU path optimizes separately).
The untwist direction and all final-exponentiation digits are derived at
import, not transcribed.

Replaces the native pairing backends behind the reference's
`eth2spec/utils/bls.py:142-222` (milagro/arkworks `pairing_check`).

The port's own copy of the JAX package's host oracle module `ops/bls/pairing.py`,
kept word for word in its arithmetic: the port imports nothing of that
package, and this module loads no JAX.
"""

from __future__ import annotations

from .curve import G2_GEN, g1, g2
from .fields import (
    BLS_X,
    FQ2_ONE,
    FQ6_ZERO,
    FQ12_ONE,
    Q,
    R,
    Fq2,
    Fq6,
    Fq12,
)

# --- embed Fq2 -> Fq12 and untwist ------------------------------------------


def _fq2_to_fq12(a: Fq2) -> Fq12:
    return Fq12(Fq6(a, Fq2(0), Fq2(0)), FQ6_ZERO)


_W = Fq12(FQ6_ZERO, Fq6(FQ2_ONE, Fq2(0), Fq2(0)))  # w
_W2 = _W * _W   # = v
_W3 = _W2 * _W


def _derive_untwist():
    """Find (cx, cy) with untwist(x,y) = (x*cx, y*cy) landing on
    y^2 = x^3 + 4 in Fq12.  Try both sextic-twist directions."""
    x, y = g2.to_affine(G2_GEN)
    X = _fq2_to_fq12(x)
    Y = _fq2_to_fq12(y)
    four = Fq12(Fq6(Fq2(4), Fq2(0), Fq2(0)), FQ6_ZERO)
    for cx, cy in ((_W2.inv(), _W3.inv()), (_W2, _W3)):
        Xp, Yp = X * cx, Y * cy
        if Yp * Yp == Xp * Xp * Xp + four:
            return cx, cy
    raise AssertionError("untwist derivation failed")


_UNTWIST_CX, _UNTWIST_CY = _derive_untwist()


def untwist(q_pt):
    """E'(Fq2) (Jacobian) -> E(Fq12) affine pair (or None for infinity)."""
    aff = g2.to_affine(q_pt)
    if aff is None:
        return None
    x, y = aff
    return (_fq2_to_fq12(x) * _UNTWIST_CX, _fq2_to_fq12(y) * _UNTWIST_CY)


# --- Miller loop in Fq12 ----------------------------------------------------


def _line(p1, p2, t):
    """Evaluate the line through p1,p2 (affine Fq12 points) at t."""
    x1, y1 = p1
    x2, y2 = p2
    tx, ty = t
    if x1 == x2 and y1 == y2:
        # tangent
        slope = (x1 * x1 * 3) * (y1 + y1).inv()
        return ty - y1 - slope * (tx - x1)
    if x1 == x2:
        # vertical
        return tx - x1
    slope = (y2 - y1) * (x2 - x1).inv()
    return ty - y1 - slope * (tx - x1)


def _add_affine(p1, p2):
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2 and y1 == y2:
        slope = (x1 * x1 * 3) * (y1 + y1).inv()
    elif x1 == x2:
        return None  # infinity (cannot occur mid-loop: loop count < r)
    else:
        slope = (y2 - y1) * (x2 - x1).inv()
    x3 = slope * slope - x1 - x2
    y3 = slope * (x1 - x3) - y1
    return (x3, y3)


def miller_loop(q_untwisted, p_affine, final: bool = True) -> Fq12:
    """f_{|x|,Q}(P), conjugated for the negative BLS parameter; optionally
    runs the final exponentiation."""
    if q_untwisted is None or p_affine is None:
        return FQ12_ONE
    T = q_untwisted
    f = FQ12_ONE
    loop = abs(BLS_X)
    px, py = p_affine
    P = (px, py)
    for bit in bin(loop)[3:]:
        f = f * f * _line(T, T, P)
        T = _add_affine(T, T)
        if bit == "1":
            f = f * _line(T, q_untwisted, P)
            T = _add_affine(T, q_untwisted)
    # BLS parameter is negative: conjugate (cheap inverse in cyclotomic group)
    f = f.conjugate()
    return final_exponentiate(f) if final else f


def _p_to_fq12_affine(p_pt):
    aff = g1.to_affine(p_pt)
    if aff is None:
        return None
    x, y = aff
    return (Fq12(Fq6(Fq2(x), Fq2(0), Fq2(0)), FQ6_ZERO),
            Fq12(Fq6(Fq2(y), Fq2(0), Fq2(0)), FQ6_ZERO))


def pairing(p_pt, q_pt, final: bool = True) -> Fq12:
    """e(P, Q) for P in G1 (Jacobian), Q in G2 (Jacobian on the twist)."""
    if g1.is_inf(p_pt) or g2.is_inf(q_pt):
        return FQ12_ONE
    return miller_loop(untwist(q_pt), _p_to_fq12_affine(p_pt), final=final)


# --- final exponentiation ---------------------------------------------------
# f^((q^12-1)/r) = easy part (q^6-1)(q^2+1), then hard part
# (q^4-q^2+1)/r decomposed in base q so each digit exponentiation is ~381
# bits and the frobenius does the q-powers.

_HARD = (Q**4 - Q**2 + 1) // R
_DIGITS = []
_tmp = _HARD
for _ in range(4):
    _DIGITS.append(_tmp % Q)
    _tmp //= Q
assert _tmp == 0


def final_exponentiate(f: Fq12) -> Fq12:
    # easy: f <- f^(q^6 - 1) = conj(f) * f^-1 ; then f <- f^(q^2) * f
    f = f.conjugate() * f.inv()
    f = f.frobenius(2) * f
    # hard: f^(d0 + d1 q + d2 q^2 + d3 q^3)
    result = FQ12_ONE
    for i, d in enumerate(_DIGITS):
        result = result * f.frobenius(i).pow(d)
    return result


def pairing_check(pairs) -> bool:
    """prod e(Pi, Qi) == 1, with a single shared final exponentiation."""
    f = FQ12_ONE
    for p_pt, q_pt in pairs:
        if g1.is_inf(p_pt) or g2.is_inf(q_pt):
            continue
        f = f * pairing(p_pt, q_pt, final=False)
    return final_exponentiate(f).is_one()
