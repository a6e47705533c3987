"""The port's Jacobian G1/G2 arithmetic (plain versions of row 9, the
curve arithmetic of kernels K8 and K9) against
`consensus_specs_tpu.ops.bls_batch.curve_jax`, limb for limb, tolerance
zero: `pt_double`, `pt_add` on generic, equal, opposite and infinite
inputs, `pt_scalar_mul` with 8-bit and 128-bit scalars, `pt_sum`, the
affine conversions and the host packers.  Points come from the JAX
package's oracle at seeded scalars; each JAX function is jitted once and
its output memoized."""

import random

import jax
import numpy as np
import pytest
import torch

from consensus_specs_tpu.ops import bls_batch as JB
from consensus_specs_tpu.ops.bls import curve as jax_curve
from consensus_specs_tpu.ops.bls_batch import curve_jax as Jc
from consensus_specs_tpu.ops.bls_batch import fq as Jf
from consensus_specs_tpu.ops.bls_batch import tower as Jt
from consensus_specs_tpu_torch.ops import bls_batch as TB
from consensus_specs_tpu_torch.ops.bls import curve as port_curve
from consensus_specs_tpu_torch.ops.bls_batch import curve as C
from consensus_specs_tpu_torch.ops.bls_batch import fq as F

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


FIELDS = {"g1": (C.F1, Jc.F1, jax_curve.g1, jax_curve.G1_GEN),
          "g2": (C.F2, Jc.F2, jax_curve.g2, jax_curve.G2_GEN)}


def _coord(group, v):
    return Jf.to_mont(v) if group is jax_curve.g1 else Jt.fq2_from_oracle(v)


def _points(group, gen, scalars, rescale=None):
    """Oracle points k * gen as (X, Y, Z) limb stacks; with `rescale`,
    each point is moved to another Jacobian representative
    (X l^2, Y l^3, Z l)."""
    pts = [group.mul(gen, k) for k in scalars]
    if rescale is not None:
        lam = rescale if group is jax_curve.g1 else jax_curve.Fq2(rescale, 3)
        mul = group.fmul
        pts = [(mul(x, mul(lam, lam)), mul(y, mul(lam, mul(lam, lam))),
                mul(z, lam)) for x, y, z in pts]
    return tuple(np.stack([_coord(group, p[i]) for p in pts])
                 for i in range(3))


def _infinity(field, n):
    one = np.broadcast_to(field.one, (n,) + field.one.shape).copy()
    return (one, one.copy(), np.zeros_like(one))


CASES = ("generic", "equal", "opposite", "p_inf", "q_inf", "both_inf")


def _add_case(name, case):
    F_t, F_j, group, gen = FIELDS[name]
    r = random.Random(2 * CASES.index(case) + (name == "g2"))
    ks = [r.randrange(1, 2**64) for _ in range(4)]
    p = _points(group, gen, ks)
    if case == "generic":
        q = _points(group, gen, [k + 7 for k in ks])
    elif case == "equal":
        q = _points(group, gen, ks, rescale=5)
    elif case == "opposite":
        q = _points(group, gen, [jax_curve.R - k for k in ks], rescale=11)
    elif case == "p_inf":
        p, q = _infinity(F_j, 4), p
    elif case == "q_inf":
        q = _infinity(F_j, 4)
    else:
        p, q = _infinity(F_j, 4), _infinity(F_j, 4)
    return p, q


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("name", ["g1", "g2"])
def test_pt_add(name, case):
    F_t, F_j = FIELDS[name][:2]
    p, q = _add_case(name, case)
    got = C.pt_add(F_t, tuple(map(_t, p)), tuple(map(_t, q)))
    want = _jax(f"add{name}", lambda a, b: Jc.pt_add(F_j, a, b), p, q)
    _same(got, want)
    inf = F.fq_canon(got[2]).numpy().reshape(4, -1).any(axis=1) == 0
    assert inf.tolist() == [case in ("opposite", "both_inf")] * 4


@pytest.mark.parametrize("name", ["g1", "g2"])
def test_pt_double(name):
    F_t, F_j, group, gen = FIELDS[name]
    p = _points(group, gen, [3, 2**70 + 1, 12345])
    p = tuple(np.concatenate([c, i]) for c, i in zip(p, _infinity(F_j, 1)))
    _same(C.pt_double(F_t, tuple(map(_t, p))),
          _jax(f"dbl{name}", lambda a: Jc.pt_double(F_j, a), p))
    dbl = group.double(group.mul(gen, 3))
    got = tuple(c[0] for c in C.pt_double(F_t, tuple(map(_t, p))))
    conv = (C.g1_limbs_to_oracle if name == "g1" else C.g2_limbs_to_oracle)
    mine = conv(got)
    if name == "g2":                  # the JAX oracle's own Fq2 class
        mine = tuple(jax_curve.Fq2(c.c0, c.c1) for c in mine)
    assert group.eq_points(mine, dbl)


@pytest.mark.parametrize("nbits", [8, 128])
@pytest.mark.parametrize("name", ["g1", "g2"])
def test_pt_scalar_mul(name, nbits):
    F_t, F_j, group, gen = FIELDS[name]
    r = random.Random(nbits)
    scalars = [1, 0] + [r.getrandbits(nbits) | 1 for _ in range(2)]
    p = _points(group, gen, [5, 6, 7, 8], rescale=9)
    bits = C.scalars_to_bits(scalars, nbits)
    got = C.pt_scalar_mul(F_t, tuple(map(_t, p)), _t(bits))
    _same(got, _jax(f"smul{name}{nbits}",
                    lambda a, b: Jc.pt_scalar_mul(F_j, a, b), p, bits))
    z = F.fq_canon(got[2]).numpy().reshape(4, -1)
    assert not z[1].any() and z[0].any()       # k = 0 -> infinity


@pytest.mark.parametrize("name,n", [("g1", 5), ("g2", 8)])
def test_pt_sum(name, n):
    F_t, F_j, group, gen = FIELDS[name]
    p = _points(group, gen, list(range(1, n + 1)), rescale=4)
    _same(C.pt_sum(F_t, tuple(map(_t, p)), n),
          _jax(f"sum{name}{n}", lambda a: Jc.pt_sum(F_j, a, n), p))


@pytest.mark.parametrize("name", ["g1", "g2"])
def test_to_affine_dev_with_an_infinite_lane(name):
    F_t, F_j, group, gen = FIELDS[name]
    p = _points(group, gen, [11, 2**100 + 3], rescale=6)
    p = tuple(np.concatenate([c, i]) for c, i in zip(p, _infinity(F_j, 1)))
    mine = TB.g1_to_affine_dev if name == "g1" else TB.g2_to_affine_dev
    ref = JB.g1_to_affine_dev if name == "g1" else JB.g2_to_affine_dev
    got = mine(tuple(map(_t, p)))
    _same(got, _jax(f"aff{name}", ref, p))
    assert got[2].tolist() == [False, False, True]


def test_host_packers_match_jax():
    r = random.Random(3)
    scalars = [0, 1, 2**128 - 1] + [r.getrandbits(128) for _ in range(5)]
    _same(C.scalars_to_bits(scalars, 128), Jc.scalars_to_bits(scalars, 128))
    # the same points from each package's own oracle
    ks = [3, 2**200 + 9]
    _same(C.g1_affine_to_limbs([port_curve.g1.mul(port_curve.G1_GEN, k)
                                for k in ks]),
          Jc.g1_affine_to_limbs([jax_curve.g1.mul(jax_curve.G1_GEN, k)
                                 for k in ks]))
    _same(C.g2_affine_to_limbs([port_curve.g2.mul(port_curve.G2_GEN, k)
                                for k in ks]),
          Jc.g2_affine_to_limbs([jax_curve.g2.mul(jax_curve.G2_GEN, k)
                                 for k in ks]))
    p = tuple(c[0] for c in _points(jax_curve.g1, jax_curve.G1_GEN, [5]))
    assert C.g1_limbs_to_oracle(p) == Jc.g1_limbs_to_oracle(p)
    q = tuple(c[0] for c in _points(jax_curve.g2, jax_curve.G2_GEN, [5]))
    mine, ref = C.g2_limbs_to_oracle(q), Jc.g2_limbs_to_oracle(q)
    assert [(c.c0, c.c1) for c in mine] == [(c.c0, c.c1) for c in ref]


def test_field_ops_tables_match_jax():
    for mine, ref in ((C.F1, Jc.F1), (C.F2, Jc.F2)):
        assert mine.name == ref.name
        _same(mine.one, ref.one)
        _same(mine.zero, ref.zero)
