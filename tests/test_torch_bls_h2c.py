"""Slice 4 of the port, device hash-to-G2: the plain PyTorch versions of
`consensus_specs_tpu_torch.ops.bls_batch.h2c` (and `curve
.pt_scalar_mul_const`) against the JAX package's `h2c_jax` and
`curve_jax` on the same inputs, limb for limb (tolerance zero: exact
finite-field arithmetic), and the whole plain `hash_to_g2_dev` against
the port's oracle `hash_to_g2`.  The JAX side runs on the CPU under
`jax.jit`; the whole JAX `hash_to_g2_dev` is `slow`, as the JAX
package's own test of it is (`tests/test_bls_kernels.py`).  Kernel K11
is held against these plain versions on the card
(`tests/test_torch_cuda.py`, `chip_smoke.py`)."""

import random

import jax
import numpy as np
import pytest
import torch

from consensus_specs_tpu.ops.bls_batch import curve_jax as Jc
from consensus_specs_tpu.ops.bls_batch import h2c_jax as Jh
from consensus_specs_tpu_torch.ops import bls_batch as TB
from consensus_specs_tpu_torch.ops.bls import curve as Tcurve
from consensus_specs_tpu_torch.ops.bls import fields as Tf
from consensus_specs_tpu_torch.ops.bls import hash_to_curve as Th2c
from consensus_specs_tpu_torch.ops.bls_batch import curve as Tc
from consensus_specs_tpu_torch.ops.bls_batch import h2c as Th
from consensus_specs_tpu_torch.ops.bls_batch import tower as Ttw

Q = Tf.Q


def _msgs(n, seed=42):
    rng = random.Random(seed)
    return [bytes(rng.randrange(256) for _ in range(32)) for _ in range(n)]


def _words(msgs):
    """(numpy uint32 words for JAX, int32 tensor of the same bits)."""
    w = Th.msgs_to_words(msgs)
    return w, torch.from_numpy(w.view(np.int32))


def _same(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.array_equal(got, want)


def _fq2(elems):
    return torch.from_numpy(np.stack([Ttw.fq2_from_oracle(e)
                                      for e in elems]))


@pytest.fixture(scope="module")
def fields():
    """u0, u1 of two messages: the port's plain hash_to_field and JAX's."""
    w_np, w_t = _words(_msgs(2))
    return Th.hash_to_field_fq2_dev(w_t), jax.jit(Jh.hash_to_field_fq2_dev)(w_np)


def test_msgs_to_words_and_templates_match_jax():
    msgs = _msgs(3)
    _same(Th.msgs_to_words(msgs), Jh.msgs_to_words(msgs))
    assert Th.msgs_to_words(msgs).dtype == np.uint32
    _same(Th._B0_TPL, Jh._B0_TPL)
    assert len(Th._BI_TPLS) == len(Jh._BI_TPLS) == 8
    for mine, ref in zip(Th._BI_TPLS, Jh._BI_TPLS):
        _same(mine, ref)
    for name in ("_C_LO", "_C_HI", "_P14_BITS", "_INV2_MONT", "_C1_L",
                 "_C2_L", "_C3_L", "_C4_L", "_Z_L", "_B2_L", "_H2_BITS"):
        _same(getattr(Th, name), getattr(Jh, name))
    assert Th._H2_BITS.size == 507 and Th._H2_BITS.sum() == 247
    with pytest.raises(AssertionError):
        Th.msgs_to_words([b"\x00" * 31])


def test_expand_message_xmd_matches_jax_and_the_oracle():
    msgs = _msgs(2)
    w_np, w_t = _words(msgs)
    got = Th.expand_message_xmd_dev(w_t)
    assert got.dtype == torch.int32 and got.shape == (2, 64)
    _same(got.numpy().view(np.uint32),
          jax.jit(Jh.expand_message_xmd_dev)(w_np))
    for row, m in zip(got.numpy().view(np.uint32), msgs):
        assert row.astype(">u4").tobytes() == Th2c.expand_message_xmd(
            m, Th2c.DST_G2, 256)


def test_hash_to_field_matches_jax(fields):
    (u0, u1), (j0, j1) = fields
    assert u0.shape == (2, 2, 33)
    _same(u0, j0)
    _same(u1, j1)


def test_fq2_sqrt_matches_jax():
    """Squares, non-squares, y = 0 with x a QR and a non-QR, and 0."""
    rng = random.Random(7)
    squares = [Tf.Fq2(rng.randrange(Q), rng.randrange(Q)).square()
               for _ in range(2)]
    non = []
    while len(non) < 2:
        e = Tf.Fq2(rng.randrange(Q), rng.randrange(Q))
        if e.sqrt() is None:
            non.append(e)
    elems = squares + non + [Tf.Fq2(4, 0), Tf.Fq2(Q - 1, 0), Tf.Fq2(0, 0)]
    a = _fq2(elems)
    root, ok = Th.fq2_sqrt_dev(a)
    jroot, jok = jax.jit(Jh.fq2_sqrt_dev)(a.numpy())
    _same(root, jroot)
    _same(ok, jok)
    assert ok.tolist() == [True, True, False, False, True, True, True]
    for r, e, is_sq in zip(root, elems, ok.tolist()):
        if is_sq:
            assert Ttw.fq2_to_oracle(r).square() == e


def test_sgn0_matches_jax():
    rng = random.Random(8)
    elems = [Tf.Fq2(rng.randrange(Q), rng.randrange(Q)) for _ in range(4)]
    elems += [Tf.Fq2(0, 0), Tf.Fq2(0, 1), Tf.Fq2(0, 2), Tf.Fq2(1, 0),
              Tf.Fq2(Q - 1, 3)]
    a = _fq2(elems)
    got = Th.sgn0_fq2_dev(a)
    _same(got, jax.jit(Jh.sgn0_fq2_dev)(a.numpy()))
    for g, e in zip(got.tolist(), elems):
        assert g == bool(e.c0 % 2 or (e.c0 == 0 and e.c1 % 2))


def test_svdw_map_matches_jax(fields):
    """The map on three hash_to_field outputs and on u = 0."""
    (u0, u1), _ = fields
    u = torch.cat([u0, u1[:1], torch.zeros_like(u0[:1])])
    x, y = Th.svdw_map_g2_dev(u)
    jx, jy = jax.jit(Jh.svdw_map_g2_dev)(u.numpy())
    _same(x, jx)
    _same(y, jy)
    for xi, yi in zip(x, y):
        assert Tcurve.g2.on_curve(Tcurve.g2.from_affine(
            Ttw.fq2_to_oracle(xi), Ttw.fq2_to_oracle(yi)))


def test_pt_scalar_mul_const_matches_jax():
    """G2 double-and-add by a short fixed scalar, from affine inputs."""
    bits = np.array([1, 0, 1, 1, 0, 1, 1], dtype=np.int32)
    pts = [Tcurve.g2.mul(Tcurve.G2_GEN, k) for k in (3, 11)]
    x, y = Tc.g2_affine_to_limbs(pts)
    one = np.broadcast_to(Ttw.FQ2_ONE_L, x.shape)
    got = Tc.pt_scalar_mul_const(
        Tc.F2, tuple(torch.from_numpy(np.ascontiguousarray(a))
                     for a in (x, y, one)), bits)
    want = jax.jit(lambda p: Jc.pt_scalar_mul_const(Jc.F2, p, bits))(
        (x, y, np.ascontiguousarray(one)))
    for g, w in zip(got, want):
        _same(g, w)
    for i, k in enumerate((3, 11)):
        assert Tcurve.g2.eq_points(
            Tc.g2_limbs_to_oracle(tuple(c[i] for c in got)),
            Tcurve.g2.mul(Tcurve.G2_GEN, k * 0b1011011))


def test_plain_hash_to_g2_equals_the_oracle():
    """The whole plain route of K11 (`bls_batch.hash_to_g2_affine` on a
    CPU tensor) on two messages: the oracle's points, affine."""
    msgs = _msgs(2)
    h_x, h_y, h_ok = TB.hash_to_g2_affine(_words(msgs)[1])
    assert h_ok.tolist() == [True, True]
    for i, m in enumerate(msgs):
        want = Tcurve.g2.to_affine(Th2c.hash_to_g2(m, Th2c.DST_G2))
        assert (Ttw.fq2_to_oracle(h_x[i]), Ttw.fq2_to_oracle(h_y[i])) == want


@pytest.mark.slow
def test_hash_to_g2_dev_matches_jax():
    w_np, w_t = _words(_msgs(2))
    got = Th.hash_to_g2_dev(w_t)
    want = jax.jit(Jh.hash_to_g2_dev)(w_np)
    for g, w in zip(got, want):
        _same(g, w)
