"""Slice 6 of the port, the G1 FFT and the FK20 hext MSM
(`consensus_specs_tpu_torch/ops/bls_batch/g1fft.py`) against the JAX
package's `ops/bls_batch/g1fft_jax.py` (tolerance zero: the arithmetic
is exact, so the plain versions of K19 and K20 equal JAX's limb for
limb).  The helpers and conversions; `pt_neg`; the plain G1 FFT and
inverse FFT at n = 8, batch 2, against JAX's `g1_fft_device`, the naive
per-point evaluation and the round trip; the plain hext MSM at 4
residues x width 8 against JAX's `fk20_hext_device` and the host
per-position `g1.msm`.  On one x86 core JAX compiles each transform in
about 35 s and the hext MSM in about 25 s; the plain FFT takes 15 s.
"""

import functools
import random

import numpy as np
import pytest
import torch

from consensus_specs_tpu.ops.bls import curve as Jcurve
from consensus_specs_tpu.ops.bls_batch import curve_jax as Jcj
from consensus_specs_tpu.ops.bls_batch import fq as Jfq
from consensus_specs_tpu.ops.bls_batch import g1fft_jax as Jgf
from consensus_specs_tpu_torch.ops.bls import curve as Tcurve
from consensus_specs_tpu_torch.ops.bls_batch import curve as Tc
from consensus_specs_tpu_torch.ops.bls_batch import fq as Tfq
from consensus_specs_tpu_torch.ops.bls_batch import g1fft as Tgf

R = Tgf.R_MODULUS


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions are thousands of small int32 ops: one intra-op
    thread runs them faster than a pool of one thread per core, and
    keeps parallel test workers from oversubscribing the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(coords):
    return tuple(np.asarray(c) for c in coords)


def _equal(port, jax):
    return all(np.array_equal(p.numpy(), j) for p, j in zip(port, jax))


@functools.cache
def _rows():
    """Two rows of 8 points in natural order: three multiples of G1 then
    infinity (JAX's tests/test_das.py vector), and eight multiples."""
    g = Tcurve.G1_GEN
    row0 = [Tcurve.g1.mul(g, s) for s in (5, 9, 11)]
    row0 += [Tcurve.g1.infinity()] * 5
    row1 = [Tcurve.g1.mul(g, s) for s in (3, 1, 4, 1, 5, 9, 2, 6)]
    return row0, row1


@functools.cache
def _limbs():
    limbs = [Tgf.points_to_limbs(r) for r in _rows()]
    return tuple(np.stack([lb[i] for lb in limbs]) for i in range(3))


@functools.cache
def _forward():
    x, y, z = _limbs()
    port = Tgf.g1_fft_device(x, y, z, device="cpu")
    jax = _np(Jgf.g1_fft_device(x, y, z))
    return port, jax


@functools.cache
def _inverse():
    _, jax_fwd = _forward()
    port = Tgf.g1_fft_device(*jax_fwd, inverse=True, device="cpu")
    jax = _np(Jgf.g1_fft_device(*jax_fwd, inverse=True))
    return port, jax


def test_helpers_match_jax():
    for n in (8, 16, 128):
        assert Tgf.fft_domain(n) == Jgf.fft_domain(n)
        assert Tgf._bitrev_perm(n) == Jgf._bitrev_perm(n)
        for inverse in (False, True):
            for t, j in zip(Tgf._stage_plan(n, inverse),
                            Jgf._stage_plan(n, inverse)):
                assert np.array_equal(t, j), (n, inverse)
    sizes = (1, 3, 8, 9, 64, 128, 129, 300)
    assert [Tgf.g1fft_rung(n) for n in sizes] == \
        [Jgf.g1fft_rung(n) for n in sizes]
    assert Tgf._inv_bits(128).tolist() == \
        [int(b) for b in bin(pow(128, R - 2, R))[2:]]


def test_points_to_limbs_and_back_match_jax():
    g = Jcurve.G1_GEN
    pts = [Jcurve.g1.mul(g, s) for s in (1, 2, 3)] + [Jcurve.g1.infinity()]
    for t, j in zip(Tgf.points_to_limbs(pts, pad_to=8),
                    Jgf.points_to_limbs(pts, pad_to=8)):
        assert np.array_equal(t, j)
    x, y, z = Tgf.points_to_limbs(pts, pad_to=8)
    assert (z[3:] == 0).all() and (x[3:] == Tfq.ONE_MONT).all()
    back = Tgf.limbs_to_oracle_list((torch.from_numpy(x), y, z))
    assert back == Jgf.limbs_to_oracle_list((x, y, z))
    for a, b in zip(back[:3], pts):
        assert Tcurve.g1.eq_points(a, b)
    assert all(Tcurve.g1.to_affine(p) is None for p in back[3:])


def test_limb_digits_match_jax_scalar_digits():
    """The device digits, from canonical limbs of the plain integers, are
    JAX's host `scalars_to_digits(.., 255, 4)`."""
    rng = random.Random(7)
    scalars = [0, 1, 15, 16, R - 1] + [rng.randrange(R) for _ in range(40)]
    want = Jcj.scalars_to_digits(scalars, 255, 4)
    limbs = torch.from_numpy(np.stack([Tfq.int_to_limbs(s)
                                       for s in scalars]))
    assert np.array_equal(Tgf.limb_digits(limbs).numpy(), want)


def test_pt_neg_matches_jax():
    x, y, z = _limbs()
    got = Tc.pt_neg(Tc.F1, tuple(torch.from_numpy(c) for c in (x, y, z)))
    want = _np(Jcj.pt_neg(Jcj.F1, (x, y, z)))
    assert _equal(got, want)
    # -P + P is infinity, P + (-P) through the plain pt_add
    p = tuple(torch.from_numpy(c[1]) for c in (x, y, z))
    s = Tc.pt_add(Tc.F1, p, Tc.pt_neg(Tc.F1, p))
    assert bool(Tfq.fq_is_zero(s[2]).all())
    assert Jfq.N_LIMBS == Tfq.N_LIMBS


def test_plain_g1_fft_matches_jax_limb_for_limb():
    port, jax = _forward()
    assert _equal(port, jax)


def test_plain_g1_fft_matches_naive_evaluation():
    port, _ = _forward()
    out = Tgf.limbs_to_oracle_list(port)
    dom = Tgf.fft_domain(8)
    for b, row in enumerate(_rows()):
        for i in range(8):
            want = Tcurve.g1.infinity()
            for j, pt in enumerate(row):
                want = Tcurve.g1.add(want,
                                     Tcurve.g1.mul(pt, dom[(i * j) % 8]))
            assert Tcurve.g1.eq_points(out[8 * b + i], want), (b, i)


def test_plain_g1_ifft_matches_jax_and_round_trips():
    port, jax = _inverse()
    assert _equal(port, jax)
    back = Tgf.limbs_to_oracle_list(port)
    for b, row in enumerate(_rows()):
        for i, pt in enumerate(row):
            assert Tcurve.g1.eq_points(back[8 * b + i], pt), (b, i)


def test_plain_hext_matches_jax_and_host_msm():
    """4 residue rows x 8 positions: Jacobian points (one lane at
    infinity), random scalars with zero ones."""
    rng = random.Random(11)
    g = Tcurve.G1_GEN
    n_res, width = 4, 8
    pts = [[Tcurve.g1.mul(g, rng.randrange(1, 1000)) for _ in range(width)]
           for _ in range(n_res)]
    # Jacobian coordinates with Z != 1 (doubled in Jacobian form), and
    # one lane at infinity
    pts = [[Tcurve.g1.double(p) for p in row] for row in pts]
    pts[2][5] = Tcurve.g1.infinity()
    scalars = [[rng.randrange(R) for _ in range(width)]
               for _ in range(n_res)]
    scalars[0][3] = 0
    scalars[1][3] = 0
    x, y, z = (np.stack([[Tfq.to_mont(p[i]) for p in row] for row in pts])
               for i in range(3))
    assert not (z == Tfq.ONE_MONT).all()
    got = Tgf.fk20_hext_device(x, y, z, scalars, device="cpu")
    want = _np(Jgf.fk20_hext_device(x, y, z, scalars))
    assert _equal(got, want)
    out = Tgf.limbs_to_oracle_list(got)
    for j in range(width):
        host = Tcurve.g1.msm([pts[c][j] for c in range(n_res)],
                             [scalars[c][j] for c in range(n_res)])
        assert Tcurve.g1.eq_points(out[j], host), j
