"""The algebra of the redesigned kernels K9 (with K25 and K26) and K11
against the JAX package, on the CPU, tolerance zero (exact
finite-field arithmetic; Montgomery limbs compared after `fq_canon`
where the kernels' canonical outputs are meant).

- The per-lane Miller accumulators that K9, K25 and K26 run
  (`csrc/bls_rlc_body.cuh`): each lane's own f_i <- f_i^2 line_i,
  conjugated and multiplied in a tree, equals the shared-accumulator
  `miller_product_batch` of the port and of JAX, with a masked lane, an
  a_inf lane and a !h_ok lane among five.
- The kernels' product by a sparse line (18 Fq2 products: its nonzero
  slots w^0, w^JX, w^JY) equals the dense `fq12_mul` by the line.
- K11's constant block (`kernels.h2c_constant_words`): the sliding-window
  digits give (p - 3) / 4 (so t^((p + 1) / 4) = t t^((p - 3) / 4)) and
  p - 2, the signed-window digits give H2.
- K11's square root (`svdw_map_group` in `csrc/bls_h2c.cu`: the norm's
  verdict, then JAX's candidates without inversions), replayed in
  Python integers over those digits, gives JAX's `fq2_sqrt_dev` root and
  verdict, and the cofactor's signed-window chain, replayed on the
  port's oracle curve, gives the affine points of JAX's `hash_to_g2_dev`
  for two messages.

The kernels themselves are held against the plain versions on the card
(`tests/test_torch_cuda.py`, `chip_smoke.py`)."""

import random

import jax
import numpy as np
import pytest
import torch

from consensus_specs_tpu.ops.bls_batch import h2c_jax as Jh
from consensus_specs_tpu.ops.bls_batch import pairing_jax as Jp
from consensus_specs_tpu_torch.ops.bls import curve as Tcurve
from consensus_specs_tpu_torch.ops.bls import fields as Tf
from consensus_specs_tpu_torch.ops.bls import hash_to_curve as Th2c
from consensus_specs_tpu_torch.ops.bls_batch import curve as Tc
from consensus_specs_tpu_torch.ops.bls_batch import fq as F
from consensus_specs_tpu_torch.ops.bls_batch import h2c as Th
from consensus_specs_tpu_torch.ops.bls_batch import kernels as K
from consensus_specs_tpu_torch.ops.bls_batch import pairing as P
from consensus_specs_tpu_torch.ops.bls_batch import tower as T

Q = Tf.Q


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions are thousands of small int32 ops: one intra-op
    thread runs them faster than a pool of one thread per core, and
    keeps parallel test workers from oversubscribing the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(a):
    return torch.from_numpy(np.array(a))


def _canon_same(got, want):
    got, want = F.fq_canon(_t(np.asarray(got))), F.fq_canon(
        _t(np.asarray(want)))
    assert got.shape == want.shape and torch.equal(got, want)


# --- K9, K25, K26: per-lane accumulators -------------------------------------


def _miller_lanes(xp, yp, xq, yq, live):
    """Each lane's own Miller value, unconjugated: f_i <- f_i^2 line_i on
    a doubling step, f_i <- f_i line_i on an addition; one on a dead lane
    (the kernels' per-lane loop, with dense products)."""
    B = xp.shape[0]
    one = F.const(T.FQ12_ONE_L, xp.device).expand((B,) + T.FQ12_ONE_L.shape)
    T_ = (xq, yq, F.const(T.FQ2_ONE_L, xp.device).expand(xq.shape))
    f = one
    for bit in P.X_BITS.tolist():
        T_, line = P._dbl_step(T_, xp, yp)
        f = T.fq12_mul(T.fq12_sqr(f), line)
        if bit:
            T_, line = P._add_step(T_, xq, yq, xp, yp)
            f = T.fq12_mul(f, line)
    return torch.where(live[:, None, None, None, None], f, one)


@pytest.fixture(scope="module")
def five_lanes():
    """Five lanes from numpy-seeded scalars: lane 1 masked, lane 2 with
    r PK at infinity (its affine limbs 0, as K8 leaves them), lane 3 with
    H at infinity (h_ok False, its limbs 0)."""
    rs = np.random.RandomState(9)
    g1 = [Tcurve.g1.mul(Tcurve.G1_GEN, int(k))
          for k in rs.randint(1, 2**62, 5)]
    g2 = [Tcurve.g2.mul(Tcurve.G2_GEN, int(k))
          for k in rs.randint(1, 2**62, 5)]
    xp, yp = Tc.g1_affine_to_limbs(g1)
    xq, yq = Tc.g2_affine_to_limbs(g2)
    xp[2] = yp[2] = 0
    xq[3] = yq[3] = 0
    mask = np.array([True, False, True, True, True])
    a_inf = np.array([False, False, True, False, False])
    h_ok = np.array([True, True, True, False, True])
    live = mask & ~a_inf & h_ok
    return xp, yp, xq, yq, live


def test_per_lane_accumulators_equal_the_shared_one_and_jax(five_lanes):
    xp, yp, xq, yq, live = five_lanes
    args = tuple(map(_t, (xp, yp, xq, yq, live)))
    shared = P.miller_product_batch(*args)
    want = jax.jit(Jp.miller_product_batch)(xp, yp, xq, yq, live)
    assert np.array_equal(shared.numpy(), np.asarray(want))
    lanes = _miller_lanes(*args)
    assert [bool(T.fq12_is_one(f)) for f in lanes] == [
        not x for x in live.tolist()]
    _canon_same(T.fq12_conj(P._product_tree(lanes, 5)), shared)
    # and the product tree of the five one-lane shared products
    singles = torch.stack([P.miller_product_batch(
        *(a[i:i + 1] for a in args)) for i in range(5)])
    _canon_same(P._product_tree(singles, 5), shared)


def _sparse_line_mul(s, l0, lx, ly):
    """The kernels' `sparse_line_mul`: coefficient i of
    s (l0 + lx w^JX + ly w^JY) from three Fq2 products, w^6 = xi."""
    a = T._w_coeffs(s)
    out = []
    for i in range(6):
        b = T.fq2_mul(a[(i - P.JX) % 6], lx)
        if i < P.JX:
            b = T.fq2_mul_xi(b)
        c = T.fq2_mul(a[(i - P.JY) % 6], ly)
        if i < P.JY:
            c = T.fq2_mul_xi(c)
        out.append(T.fq2_add(T.fq2_add(T.fq2_mul(a[i], l0), b), c))
    return T._from_w_coeffs(out)


def _rand(shape, seed):
    r = random.Random(seed)
    n = int(np.prod(shape))
    return np.stack([F.to_mont(r.randrange(Q)) for _ in range(n)]
                    ).reshape(tuple(shape) + (33,))


def test_sparse_line_product_equals_the_dense_one():
    s = _t(_rand((4, 2, 3, 2), 1))
    l0, lx, ly = (_t(_rand((4, 2), k)) for k in (2, 3, 4))
    zero = torch.zeros_like(l0)
    slots = [zero] * 6
    slots[0], slots[P.JX], slots[P.JY] = l0, lx, ly
    _canon_same(_sparse_line_mul(s, l0, lx, ly),
                T.fq12_mul(s, T._from_w_coeffs(slots)))


# --- K11: the constant block, the square root, the cofactor chain -----------

_WORDS = K.h2c_constant_words()
_TPL_WORDS = 3 * 16 + 8 * 2 * 16


def _block_digits():
    """(e_sqrt, e_inv, h2) digit lists as the kernel reads them."""
    o = _TPL_WORDS
    raw = [_WORDS[o:o + 96].view(np.int8), _WORDS[o + 96:o + 192].view(
        np.int8), _WORDS[o + 192:o + 320].view(np.int8)]
    lens = _WORDS[o + 320:o + 323].tolist()
    return [r[:n].tolist() for r, n in zip(raw, lens)]


def _digits_value(d) -> int:
    """The integer whose MSB-first binary digits (any signs) are d."""
    v = 0
    for x in d:
        v = 2 * v + int(x)
    return v


def test_h2c_constant_words_reconstruct_the_exponents_and_h2():
    e_sqrt, e_inv, h2 = _block_digits()
    assert _digits_value(e_sqrt) == (Q - 3) // 4
    assert _digits_value(e_sqrt) + 1 == (Q + 1) // 4
    assert _digits_value(e_inv) == Q - 2
    assert _digits_value(h2) == Tcurve.H2
    for d in (e_sqrt, e_inv):                 # 0 or odd below 2^5
        assert all(x == 0 or (x % 2 and 0 < x < 32) for x in d)
    assert h2[0] > 0 and all(x == 0 or (x % 2 and abs(x) < 16) for x in h2)
    nz = [i for i, x in enumerate(h2) if x]   # wNAF: 4 zeros between
    assert all(b - a >= 5 for a, b in zip(nz, nz[1:]))
    assert len(h2) - 1 == 505 and len(nz) - 1 == 86
    # the templates and the field constants keep their words
    assert np.array_equal(_WORDS[:_TPL_WORDS], np.concatenate(
        [Th._B0_TPL.ravel(), np.stack(Th._BI_TPLS).ravel()]))


def _pow_window(a, d):
    """`fp_pow_window` in integers: the table a, a^3, ..., a^31, then a
    square per digit after the first nonzero one, a product per nonzero
    digit."""
    tab = [a % Q]
    a2 = a * a % Q
    for _ in range(15):
        tab.append(tab[-1] * a2 % Q)
    k = next(i for i, x in enumerate(d) if x)
    acc = tab[d[k] >> 1]
    for x in d[k + 1:]:
        acc = acc * acc % Q
        if x:
            acc = acc * tab[x >> 1] % Q
    return acc


def _kernel_fp2_sqrt(x, y, last):
    """The square root of `svdw_map_group` in integers: (is square,
    root).  Unless `last` (x3, taken when x1 and x2 fail), a norm that
    is not a square in Fp means no root."""
    e_sqrt = _block_digits()[0]
    inv2 = pow(2, -1, Q)

    def cand(t):                        # (t^((p+1)/4), +-1 / that)
        s = _pow_window(t, e_sqrt)
        c = t * s % Q
        return c, s if c * s % Q == 1 else -s % Q

    def is_root(r0, r1):
        return ((r0 * r0 - r1 * r1) % Q, 2 * r0 * r1 % Q) == (x, y)

    if y == 0:
        c, _ = cand(x)
        if is_root(c, 0):
            return True, (c, 0)
        c, _ = cand(-x % Q)
        return is_root(0, c), (0, c)
    nrm = (x * x + y * y) % Q
    n, _ = cand(nrm)
    if not last and n * n % Q != nrm:
        return False, None
    r = None
    for t in ((x + n) % Q, (x - n) % Q):
        c, inv_c = cand(t * inv2 % Q)
        r = (c, inv_c * inv2 % Q * y % Q)
        if is_root(*r):
            return True, r
    return False, r


def test_kernel_square_root_matches_jax():
    """Squares, non-squares, y = 0 with x a QR and a non-QR, and 0: the
    verdict of both `last` settings and the root where one exists equal
    JAX's `fq2_sqrt_dev`."""
    rng = random.Random(7)
    elems = [Tf.Fq2(rng.randrange(Q), rng.randrange(Q)).square()
             for _ in range(3)]
    while len(elems) < 6:
        e = Tf.Fq2(rng.randrange(Q), rng.randrange(Q))
        if e.sqrt() is None:
            elems.append(e)
    elems += [Tf.Fq2(4, 0), Tf.Fq2(Q - 1, 0), Tf.Fq2(0, 0)]
    a = np.stack([T.fq2_from_oracle(e) for e in elems])
    root, ok = jax.jit(Jh.fq2_sqrt_dev)(a)
    root, ok = F.fq_canon(_t(np.asarray(root))), np.asarray(ok).tolist()
    assert ok == [True] * 3 + [False] * 3 + [True] * 3
    for e, r, want in zip(elems, root, ok):
        for last in (False, True):
            got, gr = _kernel_fp2_sqrt(e.c0, e.c1, last)
            assert got == want
            if want:
                assert gr == (T.fq2_to_oracle(r).c0, T.fq2_to_oracle(r).c1)


def _h2_chain(q, digits):
    """K11's clearing on the oracle curve: the table q, 3q, ..., 15q,
    then a doubling per digit after the first and an addition of
    +- table[|d| / 2] per nonzero digit."""
    g2 = Tcurve.g2
    tab = [q]
    q2 = g2.double(q)
    for _ in range(7):
        tab.append(g2.add(tab[-1], q2))
    acc = tab[digits[0] >> 1]
    for d in digits[1:]:
        acc = g2.double(acc)
        if d:
            t = tab[abs(d) >> 1]
            acc = g2.add(acc, t if d > 0 else g2.neg(t))
    return acc


def test_h2_signed_window_chain_matches_jax_hash_to_g2_dev():
    rng = random.Random(42)
    msgs = [bytes(rng.randrange(256) for _ in range(32)) for _ in range(2)]
    h2 = _block_digits()[2]
    want = jax.jit(Jh.hash_to_g2_dev)(Th.msgs_to_words(msgs))
    for i, m in enumerate(msgs):
        u0, u1 = Th2c.hash_to_field_fq2(m, 2, Th2c.DST_G2)
        q = Tcurve.g2.add(Tcurve.g2.from_affine(*Th2c.map_to_curve_g2(u0)),
                          Tcurve.g2.from_affine(*Th2c.map_to_curve_g2(u1)))
        got = Tcurve.g2.to_affine(_h2_chain(q, h2))
        jac = tuple(T.fq2_to_oracle(np.asarray(c)[i]) for c in want)
        assert got == Tcurve.g2.to_affine(jac)
        assert got == Tcurve.g2.to_affine(Th2c.hash_to_g2(m, Th2c.DST_G2))
