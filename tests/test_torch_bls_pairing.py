"""The port's pairing layer (plain versions of row 11, the arithmetic of
kernels K9 and K10) against
`consensus_specs_tpu.ops.bls_batch.pairing_jax`, limb for limb, tolerance
zero: the line placement, one doubling and one addition step of the
Miller loop, the product tree, `fq12_pow_x_abs` and the final
exponentiation (the cube of the oracle's, which is checked too), and the
derived constants.  Inputs come from the JAX package's oracle at seeded
scalars and `random.Random` seeds; each JAX function is jitted once."""

import random

import jax
import numpy as np
import pytest
import torch

from consensus_specs_tpu.ops.bls import curve as jax_curve
from consensus_specs_tpu.ops.bls import pairing as jax_pairing
from consensus_specs_tpu.ops.bls_batch import curve_jax as Jc
from consensus_specs_tpu.ops.bls_batch import fq as Jf
from consensus_specs_tpu.ops.bls_batch import pairing_jax as Jp
from consensus_specs_tpu.ops.bls_batch import tower as Jt
from consensus_specs_tpu_torch.ops.bls.fields import Q
from consensus_specs_tpu_torch.ops.bls_batch import fq as F
from consensus_specs_tpu_torch.ops.bls_batch import pairing as P
from consensus_specs_tpu_torch.ops.bls_batch import tower as T


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions are thousands of small int32 ops: one intra-op
    thread runs them faster than a pool of one thread per core, and
    keeps parallel test workers from oversubscribing the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


_JIT = {}


def _jax(name, fn, *args):
    if name not in _JIT:
        _JIT[name] = jax.jit(fn)
    return jax.tree_util.tree_map(np.asarray, _JIT[name](*args))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _same(got, want):
    if isinstance(got, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
        return
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)


def _rand(shape, seed):
    r = random.Random(seed)
    n = int(np.prod(shape))
    return np.stack([Jf.to_mont(r.randrange(Q)) for _ in range(n)]
                    ).reshape(tuple(shape) + (33,))


def _lanes(n, seed):
    """n pairing lanes: affine G1 P_i (limbs) and a Jacobian G2 T_i with
    Z != 1, plus affine G2 Q_i, from seeded scalars."""
    r = random.Random(seed)
    g1 = [jax_curve.g1.mul(jax_curve.G1_GEN, r.randrange(1, 2**64))
          for _ in range(n)]
    g2 = [jax_curve.g2.mul(jax_curve.G2_GEN, r.randrange(1, 2**64))
          for _ in range(2 * n)]
    xp, yp = Jc.g1_affine_to_limbs(g1)
    xq, yq = Jc.g2_affine_to_limbs(g2[n:])
    T_ = tuple(np.stack([Jt.fq2_from_oracle(p[i]) for p in g2[:n]])
               for i in range(3))
    return xp, yp, xq, yq, T_


def test_derived_constants_match_jax():
    assert (P.JX, P.JY) == (Jp._JX, Jp._JY)
    _same(P.SX_L, Jp._SX_L)
    _same(P.SY_L, Jp._SY_L)
    _same(P.X_BITS, Jp._X_BITS)
    _same(P.X_BITS_FULL, Jp._X_BITS_FULL)
    assert len(P.X_BITS) == 63 and int(P.X_BITS.sum()) == 5


def test_line_to_fq12():
    c0, cx, cy = _rand((3, 2), 1), _rand((3, 2), 2), _rand((3, 2), 3)
    _same(P._line_to_fq12(_t(c0), _t(cx), _t(cy)),
          _jax("line", Jp._line_to_fq12, c0, cx, cy))


def test_dbl_step():
    xp, yp, _, _, T_ = _lanes(3, 10)
    got = P._dbl_step(tuple(map(_t, T_)), _t(xp), _t(yp))
    _same(got, _jax("dbl_step", Jp._dbl_step, T_, xp, yp))


def test_add_step():
    xp, yp, xq, yq, T_ = _lanes(3, 11)
    got = P._add_step(tuple(map(_t, T_)), _t(xq), _t(yq), _t(xp), _t(yp))
    _same(got, _jax("add_step", Jp._add_step, T_, xq, yq, xp, yp))


@pytest.mark.parametrize("n", [1, 8, 9])
def test_product_tree(n):
    f = _rand((n, 2, 3, 2), 20 + n)
    _same(P._product_tree(_t(f), n),
          _jax(f"tree{n}", lambda a: Jp._product_tree(a, n), f))


def test_fq12_pow_x_abs():
    g = _rand((2, 2, 3, 2), 30)
    _same(P.fq12_pow_x_abs(_t(g)), _jax("pow_x", Jp.fq12_pow_x_abs, g))


def test_final_exponentiate_is_jax_and_the_oracle_cubed():
    """JAX's hard part is x-structured and yields the cube of the
    standard final exponentiation; so does the port's."""
    f = _rand((2, 3, 2), 31)
    got = P.final_exponentiate(_t(f))
    _same(got, _jax("final_exp", Jp.final_exponentiate, f))
    oracle = jax_pairing.final_exponentiate(Jt.fq12_to_oracle(f))
    cube = oracle * oracle * oracle
    _same(F.fq_canon(got), Jt.fq12_from_oracle(cube))


def test_miller_product_batch_masked_lanes():
    """Three lanes, the middle one masked: the shared-accumulator Miller
    product equals JAX's."""
    xp, yp, xq, yq, _ = _lanes(3, 40)
    mask = np.array([True, False, True])
    _same(P.miller_product_batch(_t(xp), _t(yp), _t(xq), _t(yq), _t(mask)),
          _jax("miller3", Jp.miller_product_batch, xp, yp, xq, yq, mask))


def test_fq12_one_and_identity_lines():
    """A fully masked batch multiplies in identity lines only: the
    product is one (conjugated)."""
    xp, yp, xq, yq, _ = _lanes(2, 41)
    mask = np.zeros(2, bool)
    got = P.miller_product_batch(_t(xp), _t(yp), _t(xq), _t(yq), _t(mask))
    assert bool(T.fq12_is_one(got))
