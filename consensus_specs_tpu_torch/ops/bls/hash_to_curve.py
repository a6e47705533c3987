"""Hash-to-curve for BLS12-381 G1/G2, RFC 9380 structure.

- expand_message_xmd(SHA-256) and hash_to_field: exact RFC 9380 §5.
- map_to_curve: Shallue–van de Woestijne (RFC 9380 §6.6.1 straight line),
  whose constants (Z, c1..c4) are fully determined by the curve equation and
  derived at import — no transcribed isogeny tables.

NOTE: the IETF ciphersuite BLS_SIG_BLS12381G2_XMD:SHA-256_SSWU_RO_POP_ uses
simplified-SWU over a 3-isogenous curve; its isogeny constant tables are not
available in this environment, so signatures here are *internally consistent
and secure* but not byte-identical to SSWU-suite implementations.  The map
is isolated behind `map_to_curve_g1/g2` so SSWU can be swapped in without
touching callers.  (Reference seam: `eth2spec/utils/bls.py` Sign/Verify.)

The port's own copy of the JAX package's host oracle module `ops/bls/hash_to_curve.py`,
kept word for word in its arithmetic: the port imports nothing of that
package, and this module loads no JAX.
"""

from __future__ import annotations

import hashlib

from .curve import B1, B2, clear_cofactor_g1, clear_cofactor_g2, g1, g2
from .fields import Q, Fq2, _fq_sqrt, fq_inv

# RFC 9380 requires a distinct DST per distinct suite: this build maps with
# SVDW, so it advertises an SVDW DST.  When the SSWU 3-isogeny constants are
# added, switch the map AND this DST to the standard
# b"BLS_SIG_BLS12381G2_XMD:SHA-256_SSWU_RO_POP_" together.
DST_G2 = b"BLS_SIG_BLS12381G2_XMD:SHA-256_SVDW_RO_POP_"


# --- RFC 9380 §5.3 expand_message_xmd --------------------------------------


def expand_message_xmd(msg: bytes, dst: bytes, len_in_bytes: int) -> bytes:
    b_in_bytes = 32  # sha256 output
    r_in_bytes = 64  # sha256 block
    ell = (len_in_bytes + b_in_bytes - 1) // b_in_bytes
    if ell > 255 or len(dst) > 255 or len_in_bytes > 65535:
        raise ValueError("expand_message_xmd: length overflow")
    dst_prime = dst + len(dst).to_bytes(1, "big")
    msg_prime = (b"\x00" * r_in_bytes + msg
                 + len_in_bytes.to_bytes(2, "big") + b"\x00" + dst_prime)
    b0 = hashlib.sha256(msg_prime).digest()
    bi = hashlib.sha256(b0 + b"\x01" + dst_prime).digest()
    out = [bi]
    for i in range(2, ell + 1):
        xored = bytes(a ^ b for a, b in zip(b0, bi))
        bi = hashlib.sha256(xored + i.to_bytes(1, "big") + dst_prime).digest()
        out.append(bi)
    return b"".join(out)[:len_in_bytes]


# --- RFC 9380 §5.2 hash_to_field -------------------------------------------

_L = 64  # ceil((381 + 128) / 8)


def hash_to_field_fq2(msg: bytes, count: int, dst: bytes) -> list[Fq2]:
    uniform = expand_message_xmd(msg, dst, count * 2 * _L)
    out = []
    for i in range(count):
        vals = []
        for j in range(2):
            off = _L * (j + i * 2)
            vals.append(int.from_bytes(uniform[off:off + _L], "big") % Q)
        out.append(Fq2(vals[0], vals[1]))
    return out


def hash_to_field_fq(msg: bytes, count: int, dst: bytes) -> list[int]:
    uniform = expand_message_xmd(msg, dst, count * _L)
    return [int.from_bytes(uniform[_L * i:_L * (i + 1)], "big") % Q
            for i in range(count)]


# --- Shallue–van de Woestijne map (RFC 9380 §6.6.1) -------------------------


class _FieldOps:
    """Shim so one SVDW implementation covers Fq and Fq2."""

    def __init__(self, is_fq2: bool):
        self.is_fq2 = is_fq2

    def from_int(self, a: int):
        return Fq2(a, 0) if self.is_fq2 else a % Q

    def add(self, a, b):
        return a + b if self.is_fq2 else (a + b) % Q

    def sub(self, a, b):
        return a - b if self.is_fq2 else (a - b) % Q

    def mul(self, a, b):
        return a * b if self.is_fq2 else a * b % Q

    def sqr(self, a):
        return a.square() if self.is_fq2 else a * a % Q

    def neg(self, a):
        return -a if self.is_fq2 else -a % Q

    def inv(self, a):
        return a.inv() if self.is_fq2 else fq_inv(a)

    def sqrt(self, a):
        return a.sqrt() if self.is_fq2 else _fq_sqrt(a)

    def sgn0(self, a):
        return a.sgn0() if self.is_fq2 else a % 2

    def is_zero(self, a):
        return a.is_zero() if self.is_fq2 else a % Q == 0

    def candidates(self):
        """Deterministic Z enumeration (RFC find_z_svdw spirit)."""
        if not self.is_fq2:
            for mag in range(1, 16):
                yield mag % Q
                yield -mag % Q
        else:
            for a in range(0, 6):
                for b in range(0, 6):
                    if a == 0 and b == 0:
                        continue
                    yield Fq2(a, b)
                    yield Fq2(-a % Q, -b % Q)


class SVDWMap:
    def __init__(self, B, is_fq2: bool):
        self.F = _FieldOps(is_fq2)
        self.B = B
        self._derive_constants()

    def g(self, x):
        F = self.F
        return F.add(F.mul(F.sqr(x), x), self.B)

    def _derive_constants(self):
        F = self.F
        for Z in F.candidates():
            gz = self.g(Z)
            if F.is_zero(gz):
                continue
            three_z2 = F.mul(F.from_int(3), F.sqr(Z))
            if F.is_zero(three_z2):
                continue
            h = F.mul(F.neg(three_z2), F.inv(F.mul(F.from_int(4), gz)))
            if F.is_zero(h) or F.sqrt(h) is None:
                continue
            c3 = F.sqrt(F.mul(F.neg(gz), three_z2))
            if c3 is None:
                continue
            # exceptional-case guard: g(Z) or g(-Z/2) must be square
            neg_z_half = F.mul(F.neg(Z), F.inv(F.from_int(2)))
            if F.sqrt(gz) is None and F.sqrt(self.g(neg_z_half)) is None:
                continue
            if F.sgn0(c3) != 0:
                c3 = F.neg(c3)
            self.Z = Z
            self.c1 = gz
            self.c2 = neg_z_half
            self.c3 = c3
            self.c4 = F.mul(F.neg(F.mul(F.from_int(4), gz)), F.inv(three_z2))
            return
        raise AssertionError("SVDW: no valid Z found")

    def map_to_curve(self, u):
        """RFC 9380 §6.6.1: returns an affine curve point (never infinity)."""
        F = self.F
        tv1 = F.mul(F.sqr(u), self.c1)
        tv2 = F.add(F.from_int(1), tv1)
        tv1 = F.sub(F.from_int(1), tv1)
        tv3 = F.mul(tv1, tv2)
        tv3 = F.inv(tv3) if not F.is_zero(tv3) else tv3  # inv0
        tv4 = F.mul(F.mul(u, tv1), F.mul(tv3, self.c3))
        x1 = F.sub(self.c2, tv4)
        x2 = F.add(self.c2, tv4)
        t = F.sqr(F.mul(F.sqr(tv2), tv3))
        x3 = F.add(F.mul(t, self.c4), self.Z)
        for x in (x1, x2, x3):
            gx = self.g(x)
            y = F.sqrt(gx)
            if y is not None:
                if F.sgn0(u) != F.sgn0(y):
                    y = F.neg(y)
                return (x, y)
        raise AssertionError("SVDW: no square candidate (impossible)")


_SVDW_G1 = SVDWMap(B1, is_fq2=False)
_SVDW_G2 = SVDWMap(B2, is_fq2=True)


def map_to_curve_g1(u: int):
    return _SVDW_G1.map_to_curve(u)


def map_to_curve_g2(u: Fq2):
    return _SVDW_G2.map_to_curve(u)


# --- hash_to_curve (random-oracle construction, RFC 9380 §3) ----------------


def hash_to_g2(msg: bytes, dst: bytes = DST_G2):
    u0, u1 = hash_to_field_fq2(msg, 2, dst)
    q0 = g2.from_affine(*map_to_curve_g2(u0))
    q1 = g2.from_affine(*map_to_curve_g2(u1))
    return clear_cofactor_g2(g2.add(q0, q1))


def hash_to_g1(msg: bytes, dst: bytes):
    u0, u1 = hash_to_field_fq(msg, 2, dst)
    q0 = g1.from_affine(*map_to_curve_g1(u0))
    q1 = g1.from_affine(*map_to_curve_g1(u1))
    return clear_cofactor_g1(g1.add(q0, q1))
