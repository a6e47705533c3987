"""BLS12-381 curve groups G1 (over Fq) and G2 (over Fq2, the sextic twist).

Jacobian-coordinate arithmetic, ZCash-format point serialization
(compressed/uncompressed with c/i/s flag bits), subgroup checks, and
multi-scalar multiplication.  Group cofactors are *derived at import* from
q, r and the CM equation (then verified against the generators) rather than
transcribed.

Plays the role of the reference's external point libraries
(`py_arkworks_bls12381` / `py_ecc` behind `eth2spec/utils/bls.py:224-397`).

The port's own copy of the JAX package's host oracle module `ops/bls/curve.py`,
kept word for word in its arithmetic: the port imports nothing of that
package, and this module loads no JAX.
"""

from __future__ import annotations

from math import isqrt

from .fields import BLS_X, FQ2_ONE, FQ2_ZERO, Q, R, Fq2, fq_inv

# Curve: y^2 = x^3 + 4       over Fq
# Twist: y^2 = x^3 + 4(u+1)  over Fq2
B1 = 4
B2 = Fq2(4, 4)

# Canonical generators (public constants of the ciphersuite)
G1_X = 0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB
G1_Y = 0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1
G2_X = Fq2(
    0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
    0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E,
)
G2_Y = Fq2(
    0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
    0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE,
)


# ---------------------------------------------------------------------------
# Generic Jacobian point math, parametrized by field ops
# ---------------------------------------------------------------------------


class _Group:
    """One curve group; fields differ (int mod Q for G1, Fq2 for G2)."""

    def __init__(self, name, b, zero, one, add, sub, mul, sqr, inv, neg,
                 is_zero, eq):
        self.name = name
        self.b = b
        self.F_zero, self.F_one = zero, one
        self.fadd, self.fsub, self.fmul, self.fsqr = add, sub, mul, sqr
        self.finv, self.fneg, self.fis_zero, self.feq = inv, neg, is_zero, eq

    # Points are (X, Y, Z) Jacobian; Z = 0 encodes infinity.

    def infinity(self):
        return (self.F_one, self.F_one, self.F_zero)

    def is_inf(self, p):
        return self.fis_zero(p[2])

    def from_affine(self, x, y):
        return (x, y, self.F_one)

    def to_affine(self, p):
        if self.is_inf(p):
            return None
        zi = self.finv(p[2])
        zi2 = self.fsqr(zi)
        return (self.fmul(p[0], zi2), self.fmul(p[1], self.fmul(zi2, zi)))

    def on_curve(self, p):
        if self.is_inf(p):
            return True
        x, y = self.to_affine(p)
        lhs = self.fsqr(y)
        rhs = self.fadd(self.fmul(self.fsqr(x), x), self.b)
        return self.feq(lhs, rhs)

    def neg(self, p):
        return (p[0], self.fneg(p[1]), p[2])

    def double(self, p):
        X, Y, Z = p
        if self.fis_zero(Z) or self.fis_zero(Y):
            return self.infinity()
        A = self.fsqr(X)
        B = self.fsqr(Y)
        C = self.fsqr(B)
        t = self.fsub(self.fsqr(self.fadd(X, B)), self.fadd(A, C))
        D = self.fadd(t, t)
        E = self.fadd(self.fadd(A, A), A)
        F = self.fsqr(E)
        X3 = self.fsub(F, self.fadd(D, D))
        eight_c = self.fadd(self.fadd(C, C), self.fadd(C, C))
        eight_c = self.fadd(eight_c, eight_c)
        Y3 = self.fsub(self.fmul(E, self.fsub(D, X3)), eight_c)
        Z3 = self.fmul(self.fadd(Y, Y), Z)
        return (X3, Y3, Z3)

    def add(self, p, q):
        if self.is_inf(p):
            return q
        if self.is_inf(q):
            return p
        X1, Y1, Z1 = p
        X2, Y2, Z2 = q
        Z1Z1 = self.fsqr(Z1)
        Z2Z2 = self.fsqr(Z2)
        U1 = self.fmul(X1, Z2Z2)
        U2 = self.fmul(X2, Z1Z1)
        S1 = self.fmul(Y1, self.fmul(Z2Z2, Z2))
        S2 = self.fmul(Y2, self.fmul(Z1Z1, Z1))
        if self.feq(U1, U2):
            if self.feq(S1, S2):
                return self.double(p)
            return self.infinity()
        H = self.fsub(U2, U1)
        I = self.fsqr(self.fadd(H, H))
        J = self.fmul(H, I)
        rr = self.fsub(S2, S1)
        rr = self.fadd(rr, rr)
        V = self.fmul(U1, I)
        X3 = self.fsub(self.fsub(self.fsqr(rr), J), self.fadd(V, V))
        t = self.fsub(V, X3)
        Y3 = self.fsub(self.fmul(rr, t), self.fadd(self.fmul(S1, J),
                                                   self.fmul(S1, J)))
        Z3 = self.fmul(self.fmul(self.fadd(Z1, Z2), self.fadd(Z1, Z2)), H)
        Z3 = self.fsub(Z3, self.fmul(Z1Z1, H))
        Z3 = self.fsub(Z3, self.fmul(Z2Z2, H))
        return (X3, Y3, Z3)

    def mul(self, p, k: int):
        k %= R  # scalars act through the r-torsion on subgroup points
        if k == 0 or self.is_inf(p):
            return self.infinity()
        acc = self.infinity()
        addend = p
        while k:
            if k & 1:
                acc = self.add(acc, addend)
            addend = self.double(addend)
            k >>= 1
        return acc

    def mul_full(self, p, k: int):
        """Scalar mult WITHOUT reduction mod r (for cofactor clearing)."""
        if k < 0:
            return self.mul_full(self.neg(p), -k)
        acc = self.infinity()
        addend = p
        while k:
            if k & 1:
                acc = self.add(acc, addend)
            addend = self.double(addend)
            k >>= 1
        return acc

    def msm(self, points, scalars):
        """Multi-scalar multiplication via Pippenger's bucket method.

        Window cost: ceil(256/c) rounds of (n bucket adds + 2^c
        accumulation adds + c doublings); c chosen from n.  ~8x over the
        naive sum at n=4096 (one KZG blob commitment)."""
        scalars = [int(s) % R for s in scalars]
        pairs = [(p, s) for p, s in zip(points, scalars)
                 if s != 0 and not self.is_inf(p)]
        if not pairs:
            return self.infinity()
        if len(pairs) == 1:
            return self.mul(pairs[0][0], pairs[0][1])

        n = len(pairs)
        # window size tuning: per-round cost is n bucket adds + 2^c
        # accumulation adds, so keep 2^c well under n
        if n < 64:
            c = 4
        elif n < 512:
            c = 7
        elif n < 4096:
            c = 10
        else:
            c = 12
        bits = R.bit_length()  # 255
        windows = range(0, bits, c)

        result = self.infinity()
        for w_start in reversed(list(windows)):
            if not self.is_inf(result):
                for _ in range(c):
                    result = self.double(result)
            buckets = [None] * (1 << c)
            for p, s in pairs:
                idx = (s >> w_start) & ((1 << c) - 1)
                if idx:
                    buckets[idx] = (p if buckets[idx] is None
                                    else self.add(buckets[idx], p))
            # sum_{i} i * bucket[i] via running suffix sums
            running = self.infinity()
            window_sum = self.infinity()
            for b in reversed(buckets[1:]):
                if b is not None:
                    running = self.add(running, b)
                window_sum = self.add(window_sum, running)
            result = self.add(result, window_sum)
        return result

    def eq_points(self, p, q):
        """Jacobian equality: X1 Z2^2 == X2 Z1^2 and Y1 Z2^3 == Y2 Z1^3."""
        if self.is_inf(p) or self.is_inf(q):
            return self.is_inf(p) and self.is_inf(q)
        Z1Z1, Z2Z2 = self.fsqr(p[2]), self.fsqr(q[2])
        if not self.feq(self.fmul(p[0], Z2Z2), self.fmul(q[0], Z1Z1)):
            return False
        return self.feq(self.fmul(p[1], self.fmul(Z2Z2, q[2])),
                        self.fmul(q[1], self.fmul(Z1Z1, p[2])))


g1 = _Group(
    "G1", B1, 0, 1,
    add=lambda a, b: (a + b) % Q,
    sub=lambda a, b: (a - b) % Q,
    mul=lambda a, b: a * b % Q,
    sqr=lambda a: a * a % Q,
    inv=fq_inv,
    neg=lambda a: -a % Q,
    is_zero=lambda a: a % Q == 0,
    eq=lambda a, b: (a - b) % Q == 0,
)

g2 = _Group(
    "G2", B2, FQ2_ZERO, FQ2_ONE,
    add=lambda a, b: a + b,
    sub=lambda a, b: a - b,
    mul=lambda a, b: a * b,
    sqr=lambda a: a.square(),
    inv=lambda a: a.inv(),
    neg=lambda a: -a,
    is_zero=lambda a: a.is_zero(),
    eq=lambda a, b: a == b,
)

G1_GEN = g1.from_affine(G1_X, G1_Y)
G2_GEN = g2.from_affine(G2_X, G2_Y)

assert g1.on_curve(G1_GEN), "G1 generator not on curve"
assert g2.on_curve(G2_GEN), "G2 generator not on twist"


# ---------------------------------------------------------------------------
# Cofactors, derived from the CM equation  t^2 - 4q = -3f^2
# ---------------------------------------------------------------------------

def _derive_cofactors():
    t = BLS_X + 1  # trace of frobenius of E/Fq
    n1 = Q + 1 - t
    assert n1 % R == 0
    h1 = n1 // R
    # order of E over Fq2: q^2 + 1 - t2 with t2 = t^2 - 2q
    t2 = t * t - 2 * Q
    # CM: t2^2 - 4q^2 = -3 f2^2
    f2_sq, rem = divmod(4 * Q * Q - t2 * t2, 3)
    assert rem == 0
    f2 = isqrt(f2_sq)
    assert f2 * f2 == f2_sq
    # the sextic twists of E/Fq2 have orders q^2 + 1 - s for
    # s in {t2, -t2, (t2±3f2)/2, (-t2±3f2)/2}; exactly one correct twist
    # order is divisible by r — select it, then verify on the generator.
    candidates = set()
    for s2 in (t2, -t2):
        for sign in (1, -1):
            num = s2 + sign * 3 * f2
            if num % 2 == 0:
                candidates.add(Q * Q + 1 - num // 2)
        candidates.add(Q * Q + 1 - s2)
    valid = [n for n in candidates if n % R == 0]
    assert valid, "no twist order divisible by r"
    h2 = None
    q_pt = _random_twist_point(12345)  # out-of-subgroup witness point
    for n in valid:
        h = n // R
        # verify: clearing by h lands the witness in the r-torsion
        cleared = g2.mul_full(q_pt, h)
        if g2.is_inf(g2.mul_full(cleared, R)) and not g2.is_inf(cleared):
            h2 = h
            break
    assert h2 is not None, "cofactor derivation failed"
    return h1, h2


def _random_twist_point(seed: int):
    """Deterministic point on the twist (NOT in the subgroup, generally)."""
    x0 = seed
    while True:
        x = Fq2(x0, 1)
        rhs = x.square() * x + B2
        y = rhs.sqrt()
        if y is not None:
            return g2.from_affine(x, y)
        x0 += 1


H1, H2 = _derive_cofactors()

assert g1.is_inf(g1.mul_full(G1_GEN, R)), "G1 generator order != r"
assert g2.is_inf(g2.mul_full(G2_GEN, R)), "G2 generator order != r"


def subgroup_check_g1(p) -> bool:
    return g1.on_curve(p) and g1.is_inf(g1.mul_full(p, R))


def subgroup_check_g2(p) -> bool:
    return g2.on_curve(p) and g2.is_inf(g2.mul_full(p, R))


def clear_cofactor_g1(p):
    return g1.mul_full(p, H1)


def clear_cofactor_g2(p):
    return g2.mul_full(p, H2)


# ---------------------------------------------------------------------------
# ZCash serialization
# ---------------------------------------------------------------------------
# Flags in the top bits of the first byte:
#   C (0x80): compressed;  I (0x40): infinity;  S (0x20): y is the
#   lexicographically larger of the two roots (only when compressed, not inf).

def _y_is_larger_g1(y: int) -> bool:
    return y > Q - y


def _y_is_larger_g2(y: Fq2) -> bool:
    # lexicographic: compare imaginary part first, then real
    if y.c1 != (Q - y.c1) % Q:
        return y.c1 > (Q - y.c1) % Q
    return y.c0 > (Q - y.c0) % Q


def g1_to_bytes(p, compressed: bool = True) -> bytes:
    aff = g1.to_affine(p)
    if aff is None:
        if compressed:
            return bytes([0xC0]) + b"\x00" * 47
        return bytes([0x40]) + b"\x00" * 95
    x, y = aff
    if compressed:
        out = bytearray(x.to_bytes(48, "big"))
        out[0] |= 0x80
        if _y_is_larger_g1(y):
            out[0] |= 0x20
        return bytes(out)
    return x.to_bytes(48, "big") + y.to_bytes(48, "big")


def g1_from_bytes(data: bytes):
    """Deserialize (and on-curve check); raises on malformed input."""
    if len(data) == 48:
        flags = data[0]
        if not flags & 0x80:
            raise ValueError("48-byte G1 must be compressed")
        if flags & 0x40:
            if any(data[1:]) or flags & 0x3F:
                raise ValueError("bad infinity encoding")
            return g1.infinity()
        x = int.from_bytes(bytes([flags & 0x1F]) + data[1:], "big")
        if x >= Q:
            raise ValueError("x >= q")
        rhs = (x * x % Q * x + B1) % Q
        y = _sqrt_fq(rhs)
        if y is None:
            raise ValueError("x not on curve")
        if bool(flags & 0x20) != _y_is_larger_g1(y):
            y = Q - y
        return g1.from_affine(x, y)
    if len(data) == 96:
        flags = data[0]
        if flags & 0x80:
            raise ValueError("96-byte G1 must be uncompressed")
        if flags & 0x40:
            if any(data[1:]) or flags & 0x3F:
                raise ValueError("bad infinity encoding")
            return g1.infinity()
        x = int.from_bytes(data[:48], "big")
        y = int.from_bytes(data[48:], "big")
        if x >= Q or y >= Q:
            raise ValueError("coordinate >= q")
        p = g1.from_affine(x, y)
        if not g1.on_curve(p):
            raise ValueError("not on curve")
        return p
    raise ValueError(f"bad G1 length {len(data)}")


def g2_to_bytes(p, compressed: bool = True) -> bytes:
    aff = g2.to_affine(p)
    if aff is None:
        if compressed:
            return bytes([0xC0]) + b"\x00" * 95
        return bytes([0x40]) + b"\x00" * 191
    x, y = aff
    if compressed:
        out = bytearray(x.c1.to_bytes(48, "big") + x.c0.to_bytes(48, "big"))
        out[0] |= 0x80
        if _y_is_larger_g2(y):
            out[0] |= 0x20
        return bytes(out)
    return (x.c1.to_bytes(48, "big") + x.c0.to_bytes(48, "big")
            + y.c1.to_bytes(48, "big") + y.c0.to_bytes(48, "big"))


def g2_from_bytes(data: bytes):
    if len(data) == 96:
        flags = data[0]
        if not flags & 0x80:
            raise ValueError("96-byte G2 must be compressed")
        if flags & 0x40:
            if any(data[1:]) or flags & 0x3F:
                raise ValueError("bad infinity encoding")
            return g2.infinity()
        x1 = int.from_bytes(bytes([flags & 0x1F]) + data[1:48], "big")
        x0 = int.from_bytes(data[48:], "big")
        if x0 >= Q or x1 >= Q:
            raise ValueError("coordinate >= q")
        x = Fq2(x0, x1)
        rhs = x.square() * x + B2
        y = rhs.sqrt()
        if y is None:
            raise ValueError("x not on twist")
        if bool(flags & 0x20) != _y_is_larger_g2(y):
            y = -y
        return g2.from_affine(x, y)
    if len(data) == 192:
        flags = data[0]
        if flags & 0x80:
            raise ValueError("192-byte G2 must be uncompressed")
        if flags & 0x40:
            if any(data[1:]) or flags & 0x3F:
                raise ValueError("bad infinity encoding")
            return g2.infinity()
        x = Fq2(int.from_bytes(data[48:96], "big"),
                int.from_bytes(data[:48], "big"))
        y = Fq2(int.from_bytes(data[144:], "big"),
                int.from_bytes(data[96:144], "big"))
        p = g2.from_affine(x, y)
        if not g2.on_curve(p):
            raise ValueError("not on twist")
        return p
    raise ValueError(f"bad G2 length {len(data)}")


def _sqrt_fq(a: int):
    a %= Q
    r_ = pow(a, (Q + 1) // 4, Q)
    return r_ if r_ * r_ % Q == a else None
