"""BLS12-381 field tower: Fq, Fq2, Fq6, Fq12.

Pure-Python reference arithmetic (the "py" oracle backend, the role py_ecc
plays for the reference — `eth2spec/utils/bls.py:20-23`).  Tower:

    Fq2  = Fq[u]  / (u^2 + 1)
    Fq6  = Fq2[v] / (v^3 - (u + 1))
    Fq12 = Fq6[w] / (w^2 - v)

All derived constants (frobenius coefficients) are *computed* at import from
q and the non-residue — no transcribed tables.

The port's own copy of the JAX package's host oracle module `ops/bls/fields.py`,
kept word for word in its arithmetic: the port imports nothing of that
package, and this module loads no JAX.
"""

from __future__ import annotations

# Base field modulus and curve order (the two canonical BLS12-381 constants)
Q = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
# BLS parameter x (negative): q, r, and the ate loop count derive from it
BLS_X = -0xD201000000010000

assert (BLS_X ** 4 - BLS_X ** 2 + 1) == R  # r = x^4 - x^2 + 1
assert ((BLS_X - 1) ** 2 * R) // 3 + BLS_X == Q  # q(x) identity (signed x)


def fq_inv(a: int) -> int:
    return pow(a, Q - 2, Q)


class Fq2:
    """a + b*u with u^2 = -1."""

    __slots__ = ("c0", "c1")

    def __init__(self, c0: int, c1: int = 0):
        self.c0 = c0 % Q
        self.c1 = c1 % Q

    def __add__(s, o):
        return Fq2(s.c0 + o.c0, s.c1 + o.c1)

    def __sub__(s, o):
        return Fq2(s.c0 - o.c0, s.c1 - o.c1)

    def __neg__(s):
        return Fq2(-s.c0, -s.c1)

    def __mul__(s, o):
        if isinstance(o, int):
            return Fq2(s.c0 * o, s.c1 * o)
        # Karatsuba: (a+bu)(c+du) = ac - bd + ((a+b)(c+d) - ac - bd)u
        t0 = s.c0 * o.c0
        t1 = s.c1 * o.c1
        t2 = (s.c0 + s.c1) * (o.c0 + o.c1)
        return Fq2(t0 - t1, t2 - t0 - t1)

    __rmul__ = __mul__

    def square(s):
        # (a+bu)^2 = (a+b)(a-b) + 2ab u
        return Fq2((s.c0 + s.c1) * (s.c0 - s.c1), 2 * s.c0 * s.c1)

    def inv(s):
        # 1/(a+bu) = (a-bu)/(a^2+b^2)
        d = fq_inv(s.c0 * s.c0 + s.c1 * s.c1)
        return Fq2(s.c0 * d, -s.c1 * d)

    def conjugate(s):
        return Fq2(s.c0, -s.c1)

    def pow(s, e: int):
        res, base = FQ2_ONE, s
        while e:
            if e & 1:
                res = res * base
            base = base.square()
            e >>= 1
        return res

    def is_zero(s):
        return s.c0 == 0 and s.c1 == 0

    def __eq__(s, o):
        return isinstance(o, Fq2) and s.c0 == o.c0 and s.c1 == o.c1

    def __hash__(s):
        return hash((s.c0, s.c1))

    def __repr__(s):
        return f"Fq2({hex(s.c0)}, {hex(s.c1)})"

    def sgn0(s) -> int:
        """RFC 9380 sign: lexicographic on (c0, c1), parity of c0 unless 0."""
        sign_0 = s.c0 % 2
        zero_0 = s.c0 == 0
        sign_1 = s.c1 % 2
        return sign_0 | (zero_0 & sign_1)

    def sqrt(s):
        """Square root in Fq2 (None if non-residue).  q^2 = 9 mod 16; use
        the generic Tonelli–Shanks via pow over the group order."""
        # candidate via a^((q^2+7)/16)-style chains is fiddly; use
        # a^((q^2+1)/... ) trick: for q = 3 mod 4, compute with norm:
        # sqrt(a) = b where b = a^((q-3)/4-ish) ... do it via Fq arithmetic:
        # write a = x + yu; |a| = x^2+y^2; if |a| is QR with root n,
        # then candidates: c = sqrt((x+n)/2) or sqrt((x-n)/2), b = c + (y/(2c))u
        x, y = s.c0, s.c1
        if y == 0:
            n = _fq_sqrt(x)
            if n is not None:
                return Fq2(n, 0)
            # sqrt of non-residue x: x = -z^2 -> sqrt = z*u
            n = _fq_sqrt((-x) % Q)
            assert n is not None
            return Fq2(0, n)
        norm = _fq_sqrt((x * x + y * y) % Q)
        if norm is None:
            return None
        for sign in (1, -1):
            t = (x + sign * norm) * fq_inv(2) % Q
            c = _fq_sqrt(t)
            if c is not None and c != 0:
                b = Fq2(c, y * fq_inv(2 * c))
                if b.square() == s:
                    return b
        return None


FQ2_ZERO = Fq2(0, 0)
FQ2_ONE = Fq2(1, 0)
FQ2_U = Fq2(0, 1)
XI = Fq2(1, 1)  # the Fq6 non-residue  v^3 = xi = 1 + u


def _fq_sqrt(a: int):
    """Square root mod q (q = 3 mod 4), None if non-residue."""
    a %= Q
    if a == 0:
        return 0
    r = pow(a, (Q + 1) // 4, Q)
    return r if r * r % Q == a else None


class Fq6:
    """a + b*v + c*v^2 with v^3 = xi."""

    __slots__ = ("c0", "c1", "c2")

    def __init__(self, c0: Fq2, c1: Fq2, c2: Fq2):
        self.c0, self.c1, self.c2 = c0, c1, c2

    def __add__(s, o):
        return Fq6(s.c0 + o.c0, s.c1 + o.c1, s.c2 + o.c2)

    def __sub__(s, o):
        return Fq6(s.c0 - o.c0, s.c1 - o.c1, s.c2 - o.c2)

    def __neg__(s):
        return Fq6(-s.c0, -s.c1, -s.c2)

    def __mul__(s, o):
        if isinstance(o, (int, Fq2)):
            return Fq6(s.c0 * o, s.c1 * o, s.c2 * o)
        a0, a1, a2 = s.c0, s.c1, s.c2
        b0, b1, b2 = o.c0, o.c1, o.c2
        t0, t1, t2 = a0 * b0, a1 * b1, a2 * b2
        return Fq6(
            t0 + ((a1 + a2) * (b1 + b2) - t1 - t2) * XI,
            (a0 + a1) * (b0 + b1) - t0 - t1 + t2 * XI,
            (a0 + a2) * (b0 + b2) - t0 - t2 + t1,
        )

    __rmul__ = __mul__

    def square(s):
        return s * s

    def mul_by_v(s):
        """v * (a + bv + cv^2) = c*xi + a v + b v^2."""
        return Fq6(s.c2 * XI, s.c0, s.c1)

    def inv(s):
        a, b, c = s.c0, s.c1, s.c2
        t0 = a.square() - b * c * XI
        t1 = c.square() * XI - a * b
        t2 = b.square() - a * c
        d = (a * t0 + (c * t1 + b * t2) * XI).inv()
        return Fq6(t0 * d, t1 * d, t2 * d)

    def is_zero(s):
        return s.c0.is_zero() and s.c1.is_zero() and s.c2.is_zero()

    def __eq__(s, o):
        return isinstance(o, Fq6) and s.c0 == o.c0 and s.c1 == o.c1 and s.c2 == o.c2

    def __hash__(s):
        return hash((s.c0, s.c1, s.c2))

    def __repr__(s):
        return f"Fq6({s.c0!r}, {s.c1!r}, {s.c2!r})"


FQ6_ZERO = Fq6(FQ2_ZERO, FQ2_ZERO, FQ2_ZERO)
FQ6_ONE = Fq6(FQ2_ONE, FQ2_ZERO, FQ2_ZERO)


class Fq12:
    """a + b*w with w^2 = v."""

    __slots__ = ("c0", "c1")

    def __init__(self, c0: Fq6, c1: Fq6):
        self.c0, self.c1 = c0, c1

    def __add__(s, o):
        return Fq12(s.c0 + o.c0, s.c1 + o.c1)

    def __sub__(s, o):
        return Fq12(s.c0 - o.c0, s.c1 - o.c1)

    def __neg__(s):
        return Fq12(-s.c0, -s.c1)

    def __mul__(s, o):
        if isinstance(o, (int, Fq2, Fq6)):
            return Fq12(s.c0 * o, s.c1 * o)
        t0 = s.c0 * o.c0
        t1 = s.c1 * o.c1
        t2 = (s.c0 + s.c1) * (o.c0 + o.c1)
        return Fq12(t0 + t1.mul_by_v(), t2 - t0 - t1)

    __rmul__ = __mul__

    def square(s):
        t0 = s.c0 * s.c1
        a = (s.c0 + s.c1) * (s.c0 + s.c1.mul_by_v())
        return Fq12(a - t0 - t0.mul_by_v(), t0 + t0)

    def inv(s):
        d = (s.c0 * s.c0 - (s.c1 * s.c1).mul_by_v()).inv()
        return Fq12(s.c0 * d, -(s.c1 * d))

    def conjugate(s):
        """The p^6 frobenius: w -> -w."""
        return Fq12(s.c0, -s.c1)

    def pow(s, e: int):
        if e < 0:
            return s.inv().pow(-e)
        res, base = FQ12_ONE, s
        while e:
            if e & 1:
                res = res * base
            base = base.square()
            e >>= 1
        return res

    def frobenius(s, power: int = 1):
        """x -> x^(q^power), via coefficient conjugation + basis constants."""
        power %= 12
        res = s
        for _ in range(power):
            res = _frobenius_once(res)
        return res

    def is_one(s):
        return s.c0 == FQ6_ONE and s.c1.is_zero()

    def __eq__(s, o):
        return isinstance(o, Fq12) and s.c0 == o.c0 and s.c1 == o.c1

    def __hash__(s):
        return hash((s.c0, s.c1))

    def __repr__(s):
        return f"Fq12({s.c0!r}, {s.c1!r})"


FQ12_ZERO = Fq12(FQ6_ZERO, FQ6_ZERO)
FQ12_ONE = Fq12(FQ6_ONE, FQ6_ZERO)
FQ12_W = Fq12(FQ6_ZERO, FQ6_ONE)  # the tower generator w

# --- frobenius coefficients (derived, not transcribed) ---------------------
# Basis of Fq12 over Fq2: w^i for i in 0..5 interleaved through the Fq6
# coefficients: element = (c0.c0 + c0.c1 v + c0.c2 v^2) + (c1.c0 + ...) w
# with v = w^2.  frobenius maps u -> -u on each Fq2 coefficient and
# multiplies the w^i basis element by gamma_i = xi^(i*(q-1)/6) since
# (w^i)^q = w^i * xi^(i(q-1)/6)  (w^6 = xi).

_GAMMA = [XI.pow(i * (Q - 1) // 6) for i in range(6)]


def _frobenius_once(f: Fq12) -> Fq12:
    # coefficients in w-power order: w^0..w^5
    coeffs = [f.c0.c0, f.c1.c0, f.c0.c1, f.c1.c1, f.c0.c2, f.c1.c2]
    mapped = [c.conjugate() * _GAMMA[i] for i, c in enumerate(coeffs)]
    c0 = Fq6(mapped[0], mapped[2], mapped[4])
    c1 = Fq6(mapped[1], mapped[3], mapped[5])
    return Fq12(c0, c1)
