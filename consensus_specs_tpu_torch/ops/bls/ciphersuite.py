"""BLS signature scheme (proof-of-possession scheme shape, pubkeys in G1,
signatures in G2) + the point API the KZG library uses.

Mirrors the functional surface of the reference facade
(`eth2spec/utils/bls.py:141-397`): Sign/Verify/Aggregate/AggregateVerify/
FastAggregateVerify/AggregatePKs/SkToPk/KeyValidate/pairing_check/multi_exp
and the G1/G2 byte converters.

The port's own copy of the JAX package's host oracle module `ops/bls/ciphersuite.py`,
kept word for word in its arithmetic: the port imports nothing of that
package, and this module loads no JAX.
"""

from __future__ import annotations

from .curve import (
    G1_GEN,
    G2_GEN,
    g1,
    g1_from_bytes,
    g1_to_bytes,
    g2,
    g2_from_bytes,
    g2_to_bytes,
    subgroup_check_g1,
    subgroup_check_g2,
)
from .fields import R
from .hash_to_curve import DST_G2, hash_to_g2
from .pairing import pairing_check as _pairing_check

G1_POINT_AT_INFINITY = b"\xc0" + b"\x00" * 47
G2_POINT_AT_INFINITY = b"\xc0" + b"\x00" * 95


# --- key & point plumbing ---------------------------------------------------


def SkToPk(privkey: int) -> bytes:
    assert 0 < privkey < R
    return g1_to_bytes(g1.mul(G1_GEN, privkey))


def KeyValidate(pubkey: bytes) -> bool:
    try:
        p = g1_from_bytes(pubkey)
    except ValueError:
        return False
    if g1.is_inf(p):
        return False
    return subgroup_check_g1(p)


def _sig_to_point(signature: bytes):
    p = g2_from_bytes(signature)
    if not subgroup_check_g2(p):
        raise ValueError("signature not in G2 subgroup")
    return p


def _pk_to_point(pubkey: bytes):
    p = g1_from_bytes(pubkey)
    if g1.is_inf(p) or not subgroup_check_g1(p):
        raise ValueError("invalid pubkey")
    return p


def parse_fast_aggregate_task(pubkeys, message, signature):
    """Eager wire-format validation for one FastAggregateVerify
    statement, shared by `DeferredBatch.record` (the block path) and
    `ServeExecutor.submit_fast_aggregate_verify` (the serving path) so
    the two can never drift on accept/reject behavior.  Returns the
    (aggregate_pk_jacobian, message_bytes, sig_jacobian) task tuple the
    batched RLC kernel consumes, or None when the inputs are invalid
    (empty pubkey list, unparseable/out-of-subgroup points) — the
    False verdict is decided here, without touching a kernel."""
    if len(pubkeys) == 0:
        return None
    try:
        sig = _sig_to_point(bytes(signature))
        agg = g1.infinity()
        for pk in pubkeys:
            agg = g1.add(agg, _pk_to_point(bytes(pk)))
    except ValueError:
        return None
    return (agg, bytes(message), sig)


def fast_aggregate_pairs(task):
    """The pairing-product statement for one parsed FastAggregateVerify
    task: e(PK, H(m)) · e(-G1, S) == 1, as the [(g1, g2), ...] pair
    list every pairing-check backend consumes.  The ONE definition of
    the verification identity — the oracle path, the deferred-batch
    host fallback, the serve recheck, and the load generator all call
    this, so the formula cannot drift between them."""
    pk, msg, sig = task
    return [(pk, hash_to_g2(bytes(msg), DST_G2)), (g1.neg(G1_GEN), sig)]


# --- core scheme ------------------------------------------------------------


def Sign(privkey: int, message: bytes) -> bytes:
    assert 0 < privkey < R
    return g2_to_bytes(g2.mul(hash_to_g2(message, DST_G2), privkey))


def Verify(pubkey: bytes, message: bytes, signature: bytes) -> bool:
    try:
        pk = _pk_to_point(pubkey)
        sig = _sig_to_point(signature)
    except ValueError:
        return False
    h = hash_to_g2(message, DST_G2)
    # e(pk, H(m)) * e(-g1, sig) == 1
    return _pairing_check([(pk, h), (g1.neg(G1_GEN), sig)])


def Aggregate(signatures: list[bytes]) -> bytes:
    assert len(signatures) > 0
    acc = g2.infinity()
    for s in signatures:
        acc = g2.add(acc, _sig_to_point(s))
    return g2_to_bytes(acc)


def AggregatePKs(pubkeys: list[bytes]) -> bytes:
    assert len(pubkeys) > 0
    acc = g1.infinity()
    for pk in pubkeys:
        acc = g1.add(acc, _pk_to_point(pk))
    return g1_to_bytes(acc)


def AggregateVerify(pubkeys: list[bytes], messages: list[bytes],
                    signature: bytes) -> bool:
    if len(pubkeys) == 0 or len(pubkeys) != len(messages):
        return False
    try:
        sig = _sig_to_point(signature)
        pks = [_pk_to_point(pk) for pk in pubkeys]
    except ValueError:
        return False
    pairs = [(pk, hash_to_g2(msg, DST_G2)) for pk, msg in zip(pks, messages)]
    pairs.append((g1.neg(G1_GEN), sig))
    return _pairing_check(pairs)


def FastAggregateVerify(pubkeys: list[bytes], message: bytes,
                        signature: bytes) -> bool:
    if len(pubkeys) == 0:
        return False
    try:
        sig = _sig_to_point(signature)
        agg = g1.infinity()
        for pk in pubkeys:
            agg = g1.add(agg, _pk_to_point(pk))
    except ValueError:
        return False
    return _pairing_check(fast_aggregate_pairs((agg, message, sig)))


# --- point API for the KZG / polynomial-commitment library ------------------
# (reference surface: `eth2spec/utils/bls.py:224-397`)


def add(a, b):
    """Group add; operands are (group_tag, jacobian) pairs from this API."""
    tag_a, pa = a
    tag_b, pb = b
    assert tag_a == tag_b
    grp = g1 if tag_a == 1 else g2
    return (tag_a, grp.add(pa, pb))


def multiply(a, n: int):
    tag, p = a
    grp = g1 if tag == 1 else g2
    return (tag, grp.mul(p, int(n)))


def neg(a):
    tag, p = a
    grp = g1 if tag == 1 else g2
    return (tag, grp.neg(p))


def multi_exp(points, integers):
    assert len(points) == len(integers) and len(points) > 0
    tag = points[0][0]
    grp = g1 if tag == 1 else g2
    return (tag, grp.msm([p for _, p in points], [int(i) for i in integers]))


def eq(a, b):
    tag_a, pa = a
    tag_b, pb = b
    if tag_a != tag_b:
        return False
    grp = g1 if tag_a == 1 else g2
    return grp.eq_points(pa, pb)


def Z1():
    return (1, g1.infinity())


def Z2():
    return (2, g2.infinity())


def G1():
    return (1, G1_GEN)


def G2():
    return (2, G2_GEN)


def G1_to_bytes48(a) -> bytes:
    tag, p = a
    assert tag == 1
    return g1_to_bytes(p)


def G2_to_bytes96(a) -> bytes:
    tag, p = a
    assert tag == 2
    return g2_to_bytes(p)


def bytes48_to_G1(b: bytes):
    return (1, g1_from_bytes(bytes(b)))


def bytes96_to_G2(b: bytes):
    return (2, g2_from_bytes(bytes(b)))


def pairing_check(values) -> bool:
    """values: list of ((1, G1pt), (2, G2pt)) pairs."""
    pairs = []
    for (tag1, p), (tag2, q) in values:
        assert tag1 == 1 and tag2 == 2
        pairs.append((p, q))
    return _pairing_check(pairs)
