"""The algebra of the redesigned pairing-check kernels K12 and K10 against
the JAX package, on the CPU, tolerance zero (exact finite-field
arithmetic; Montgomery limbs compared after `fq_canon`).

- K12 (`csrc/bls_pairing.cu` on `csrc/bls_rlc_body.cuh`'s per-lane
  body): each live lane's own f_i <- f_i^2 line_i over the precomputed
  lines, the line's x and y terms evaluated as the first launch does
  (cx (sx xp), cy (sy yp)) and multiplied in by the sparse product, the
  live lanes' values conjugated and multiplied, equals JAX's
  `miller_product_precomp` (the shared accumulator) at bucket 8 with 1,
  2 and 6 live lanes.
- K10 (`csrc/bls_rlc.cu`): the Granger-Scott cyclotomic square, by the
  kernel's formulas on the port's plain tower, equals `fq12_sqr` on the
  easy-part images of three seeded f and on 0; and the kernel's chain
  replayed on the plain tower (the Fq12 inverse with its Fp inversion by
  the sliding window over the constant block's digits of p - 2, the hard
  part with cyclotomic squares and each power by |x| from g on the top
  bit) equals JAX's `final_exponentiate` at f = 1, f = 0, a random Fq12,
  and the Miller values of a true and a false pairing check, whose
  verdicts it gives.

The kernels themselves are held against the plain versions on the card
(`tests/test_torch_cuda.py`, `chip_smoke.py`)."""

import random

import jax
import numpy as np
import pytest
import torch

from consensus_specs_tpu.ops.bls_batch import pairing_jax as Jp
from consensus_specs_tpu_torch.ops import bls_batch as TB
from consensus_specs_tpu_torch.ops.bls import curve as C
from consensus_specs_tpu_torch.ops.bls import fields as Tf
from consensus_specs_tpu_torch.ops.bls_batch import fq as F
from consensus_specs_tpu_torch.ops.bls_batch import kernels as K
from consensus_specs_tpu_torch.ops.bls_batch import pairing as P
from consensus_specs_tpu_torch.ops.bls_batch import tower as T

Q = Tf.Q
WINDOW_TABLE = 16   # `FP_WINDOW_TABLE` of `bls12_381.cuh`


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


def _check_inputs(n_live, seed, true=False):
    """`pairing_check_inputs` for n_live pairs from seeded scalars (padded
    to the bucket: 8 lanes up to 8 live, then 32); with `true`, n_live =
    2 pairs whose pairings cancel."""
    r = random.Random(seed)
    if true:
        p, k = C.g1.mul(C.G1_GEN, r.randrange(1, 2**64)), r.randrange(1, 2**64)
        pairs = [(p, C.g2.mul(C.G2_GEN, k)),
                 (C.g1.mul(C.g1.neg(p), k), C.G2_GEN)]
    else:
        pairs = [(C.g1.mul(C.G1_GEN, r.randrange(1, 2**64)),
                  C.g2.mul(C.G2_GEN, r.randrange(1, 2**64)))
                 for _ in range(n_live)]
    return TB.pairing_check_inputs(pairs)


_JAX = {}


def _jax(name, fn, *args):
    """JAX outputs, memoized over the module (one compile per shape)."""
    if name not in _JAX:
        _JAX[name] = np.asarray(fn(*args))
    return _JAX[name]


_J_PRECOMP = jax.jit(Jp.miller_product_precomp)
_J_FINAL_EXP = jax.jit(Jp.final_exponentiate)


# --- K12: per-lane accumulators over the precomputed lines ------------------


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


def _precomp_lanes(xp, yp, lines, mask):
    """K12's three launches on the plain tower: the live lanes' line terms
    (c0, cx (sx xp), cy (sy yp)), each live lane's own Miller value by
    the square and the sparse product, then conj and the product tree."""
    live = np.flatnonzero(mask)
    xp, yp, lines = _t(xp)[live], _t(yp)[live], _t(lines)[:, live]
    n = len(live)
    sx = F.const(P.SX_L, "cpu").expand((n, 2, 33))
    sy = F.const(P.SY_L, "cpu").expand((n, 2, 33))
    xs, ys = T.fq2_mul_fq(sx, xp), T.fq2_mul_fq(sy, yp)
    f = F.const(T.FQ12_ONE_L, "cpu").expand((n,) + T.FQ12_ONE_L.shape)
    for k, bit in enumerate(P.X_BITS.tolist()):
        L = lines[k]
        f = _sparse_line_mul(T.fq12_sqr(f), L[:, 0], T.fq2_mul(L[:, 1], xs),
                             T.fq2_mul(L[:, 2], ys))
        if bit:
            f = _sparse_line_mul(f, L[:, 3], T.fq2_mul(L[:, 4], xs),
                                 T.fq2_mul(L[:, 5], ys))
    return P._product_tree(T.fq12_conj(f), n)


@pytest.mark.parametrize("n_live,bucket", [
    (1, 8), (2, 8), (6, 8),
    pytest.param(32, 32, marks=pytest.mark.slow)])
def test_per_lane_precomputed_lines_equal_jax(n_live, bucket):
    xp, yp, lines, mask = _check_inputs(n_live, 100 + n_live)
    assert xp.shape[0] == bucket
    want = _jax(f"precomp{n_live}", _J_PRECOMP, xp, yp, lines, mask)
    _canon_same(_precomp_lanes(xp, yp, lines, mask), want)


# --- K10: the cyclotomic square and the chain ------------------------------


def _e(a, i):
    """Fq2 coefficient i of an Fq12 in `Fp12` order (c0.c0, c0.c1, c0.c2,
    c1.c0, c1.c1, c1.c2), as the kernel indexes it."""
    return a[..., i // 3, i % 3, :, :]


def _from_e(c):
    return torch.stack([torch.stack(c[:3], dim=-3),
                        torch.stack(c[3:], dim=-3)], dim=-4)


def _cyc_sqr(a):
    """`fe_cyc_sqr`: the Fq4 squares (x^2 + xi y^2, (x + y)^2 - x^2 - y^2)
    of (a0, a4), (a3, a2), (a1, a5), then out[k] = 3 A_k - 2 a_k (k < 3)
    and out[3, 4, 5] = 3 (xi B_2, B_0, B_1) + 2 a_k.  Canonical out, as
    the kernel's values are (the sums' lazy limbs would grow each square)."""
    pairs = [(0, 4), (3, 2), (1, 5)]
    A, Bs = [], []
    for x, y in pairs:
        x, y = _e(a, x), _e(a, y)
        xx, yy = T.fq2_sqr(x), T.fq2_sqr(y)
        s = T.fq2_sqr(T.fq2_add(x, y))
        A.append(T.fq2_add(xx, T.fq2_mul_xi(yy)))
        Bs.append(T.fq2_sub(T.fq2_sub(s, xx), yy))
    hs = [A[0], A[1], A[2], T.fq2_mul_xi(Bs[2]), Bs[0], Bs[1]]
    out = []
    for k, h in enumerate(hs):
        w = T.fq2_sub(h, _e(a, k)) if k < 3 else T.fq2_add(h, _e(a, k))
        out.append(T.fq2_add(T.fq2_mul_small(w, 2), h))
    return F.fq_canon(_from_e(out))


def _rand_fq12(seed):
    r = random.Random(seed)
    return _t(np.stack([F.to_mont(r.randrange(Q)) for _ in range(12)])
              .reshape(1, 2, 3, 2, 33))


def _easy_part(f):
    f1 = T.fq12_mul(T.fq12_conj(f), T.fq12_inv(f))
    return T.fq12_mul(T.fq12_frobenius(f1, 2), f1)


def test_cyclotomic_square_equals_fq12_sqr_on_the_easy_part():
    f = torch.cat([_rand_fq12(s) for s in (1, 2, 3)] +
                  [torch.zeros((1, 2, 3, 2, 33), dtype=torch.int32)])
    m = _easy_part(f)
    assert not bool(T.fq12_is_one(m[0]))
    _canon_same(_cyc_sqr(m), T.fq12_sqr(m))
    # off the subgroup the formula is not a square: the test can tell
    assert not torch.equal(F.fq_canon(_cyc_sqr(f[:1])),
                           F.fq_canon(T.fq12_sqr(f[:1])))


def _inv_digits():
    """The sliding-window digits of p - 2 in `kernels.constant_words`
    (`BlsConstants.e_inv`, after the 281 words of the older fields)."""
    w = K.constant_words()
    n = int(w[281 + K.FP_INV_DIGITS // 4])
    return w[281:281 + K.FP_INV_DIGITS // 4].view(np.int8)[:n].tolist()


def _pow_window(a, d):
    """`fp_pow_window` on limbs: the odd powers a .. a^31, a square per
    digit after the first nonzero one, a product per nonzero digit."""
    tab = [a]
    a2 = F.fq_sqr(a)
    for _ in range(WINDOW_TABLE - 1):
        tab.append(F.fq_mul(tab[-1], a2))
    k = next(i for i, x in enumerate(d) if x)
    acc = tab[d[k] >> 1]
    for x in d[k + 1:]:
        acc = F.fq_sqr(acc)
        if x:
            acc = F.fq_mul(acc, tab[x >> 1])
    return acc


def _fq12_inv_window(a, d):
    """`fe_inv`: 1 / (a0 + a1 w) = (a0 - a1 w) / n, n = a0^2 - v a1^2,
    n^-1 by fp6_inv's formulas, its Fp inversion by the window chain."""
    a0, a1 = a[..., 0, :, :, :], a[..., 1, :, :, :]
    n = T.fq6_sub(T.fq6_mul(a0, a0), T.fq6_mul_by_v(T.fq6_mul(a1, a1)))
    n0, n1, n2 = (n[..., k, :, :] for k in range(3))
    t0 = T.fq2_sub(T.fq2_mul(n0, n0), T.fq2_mul_xi(T.fq2_mul(n1, n2)))
    t1 = T.fq2_sub(T.fq2_mul_xi(T.fq2_mul(n2, n2)), T.fq2_mul(n0, n1))
    t2 = T.fq2_sub(T.fq2_mul(n1, n1), T.fq2_mul(n0, n2))
    x = T.fq2_add(T.fq2_mul_xi(T.fq2_add(T.fq2_mul(n2, t1),
                                         T.fq2_mul(n1, t2))),
                  T.fq2_mul(n0, t0))
    norm = F.fq_add(F.fq_sqr(x[..., 0, :]), F.fq_sqr(x[..., 1, :]))
    i = _pow_window(norm, d)
    d2 = torch.stack([F.fq_mul(x[..., 0, :], i),
                      F.fq_neg(F.fq_mul(x[..., 1, :], i))], dim=-2)
    i6 = torch.stack([T.fq2_mul(t, d2) for t in (t0, t1, t2)], dim=-3)
    return torch.stack([T.fq6_mul(a0, i6), T.fq6_neg(T.fq6_mul(a1, i6))],
                       dim=-4)


def _pow_x(g):
    """`fe_pow_x`: conj(g^|x|), from g on |x|'s top bit, a cyclotomic
    square per lower bit and a product by g per set one."""
    acc = g
    for bit in P.X_BITS.tolist():
        acc = _cyc_sqr(acc)
        if bit:
            acc = T.fq12_mul(acc, g)
    return T.fq12_conj(acc)


def _final_exp_chain(f, d):
    """`final_exp_is_one_kernel`'s chain on the plain tower."""
    f1 = T.fq12_mul(T.fq12_conj(f), _fq12_inv_window(f, d))
    m = T.fq12_mul(T.fq12_frobenius(f1, 2), f1)
    t = T.fq12_mul(_pow_x(m), T.fq12_conj(m))
    t1 = T.fq12_mul(_pow_x(t), T.fq12_conj(t))
    t2 = T.fq12_mul(_pow_x(t1), T.fq12_frobenius(t1, 1))
    t3 = T.fq12_mul(_pow_x(_pow_x(t2)), T.fq12_frobenius(t2, 2))
    t3 = T.fq12_mul(t3, T.fq12_conj(t2))
    return T.fq12_mul(t3, T.fq12_mul(_cyc_sqr(m), m))


def test_inverse_digits_give_p_minus_2():
    d = _inv_digits()
    v = 0
    for x in d:
        v = 2 * v + x
    assert v == Q - 2
    assert all(x == 0 or (x % 2 and 0 < x < 32) for x in d)
    a = _t(np.stack([F.to_mont(x) for x in (0, 1, 2, Q - 1, 123456789)]))
    got = [F.from_mont(x) for x in F.fq_canon(_pow_window(a, d))]
    assert got == [0, 1, pow(2, -1, Q), Q - 1, pow(123456789, -1, Q)]


def test_final_exp_chain_equals_jax():
    true_in = _check_inputs(2, 7, true=True)
    false_in = _check_inputs(2, 8)
    millers = [_jax("precomp_true", _J_PRECOMP, *true_in),
               _jax("precomp_false", _J_PRECOMP, *false_in)]
    f = torch.cat([F.const(T.FQ12_ONE_L, "cpu")[None],
                   torch.zeros((1, 2, 3, 2, 33), dtype=torch.int32),
                   _rand_fq12(11), _t(np.stack(millers))])
    want = _jax("final_exp", _J_FINAL_EXP, f.numpy())
    got = _final_exp_chain(f, _inv_digits())
    _canon_same(got, want)
    assert [bool(x) for x in T.fq12_is_one(F.fq_canon(got))] == [
        True, False, False, True, False]
    assert not bool(F.fq_canon(got[1]).any())          # 0 -> 0
