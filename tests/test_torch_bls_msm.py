"""Slice 4 of the port, the G1 multiscalar multiplication: the digit
layout and the plain Pippenger against the JAX package's `curve_jax`
(limb for limb, tolerance zero), `g1_multi_exp_device(device="cpu")`
against the oracle `g1.msm` for both algorithms with zero-scalar and
infinity lanes, the crossover and window choices against JAX's, and the
facade's `multi_exp` routing at 15 and 16 points.  Kernels K13 and K14
are held against the plain versions on the card
(`tests/test_torch_cuda.py`, `chip_smoke.py`)."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consensus_specs_tpu.ops import bls_batch as JB
from consensus_specs_tpu.ops.bls_batch import curve_jax as Jc
from consensus_specs_tpu.ops.bls_batch import fq as Jf
from consensus_specs_tpu_torch.ops import bls as TBLS
from consensus_specs_tpu_torch.ops import bls_batch as TB
from consensus_specs_tpu_torch.ops.bls import curve as C
from consensus_specs_tpu_torch.ops.bls_batch import curve as Tc

R = C.R


def _probe(n):
    """bench_bls.py:143's MSM probe: points (3i + 2) G1, scalars 5^(i+1)."""
    return ([C.g1.mul(C.G1_GEN, 3 * i + 2) for i in range(n)],
            [pow(5, i + 1, R) for i in range(n)])


@pytest.mark.parametrize("c", [4, 6, 8, 10])
def test_scalars_to_digits_match_jax(c):
    rng = random.Random(c)
    ks = [0, 1, R - 1, (1 << 255) - 1] + [rng.randrange(R) for _ in range(4)]
    got = Tc.scalars_to_digits(ks, 255, c)
    want = Jc.scalars_to_digits(ks, 255, c)
    assert got.dtype == want.dtype == np.int32
    assert got.shape == (8, -(-255 // c)) and np.array_equal(got, want)
    # the ragged top window holds the 255 - c * (W - 1) high bits
    top = 255 - c * (got.shape[1] - 1)
    assert got[3, 0] == (1 << top) - 1 and (got[:, 0] < 1 << top).all()


def test_window_and_crossover_match_jax():
    for n in (1, 8, 31, 32, 255, 256, 512, 2047, 2048, 4096):
        assert TB._msm_window(n) == JB._msm_window(n), n
    assert TB._MSM_PIPPENGER_MAX == JB._MSM_PIPPENGER_MAX == 512
    assert TB._msm_algo(512) == "pippenger"
    assert TB._msm_algo(1024) == "double-add"
    assert TB._msm_algo(8, "double-add") == "double-add"


def test_msm_inputs_drop_dead_lanes_and_pad():
    pts, ks = _probe(5)
    pts += [C.g1.infinity(), C.G1_GEN]
    ks += [7, R]                                # R reduces to zero
    algo, c, (x, y, digits) = TB.msm_inputs(pts, ks)
    assert (algo, c) == ("pippenger", 4) and x.shape == (8, 33)
    assert (x[5:] == x[0]).all() and not digits[5:].any()
    algo, c, (x, y, bits, mask) = TB.msm_inputs(pts, ks, "double-add")
    assert c is None and bits.shape == (8, 255)
    assert mask.tolist() == [True] * 5 + [False] * 3
    assert TB.msm_inputs([C.G1_GEN], [0]) is None


def test_pt_msm_pippenger_matches_jax():
    """B = 8, c = 4: every Jacobian coordinate equals JAX's."""
    pts, ks = _probe(8)
    x, y = Tc.g1_affine_to_limbs(pts)
    digits = Tc.scalars_to_digits(ks, 255, 4)
    got = TB.msm_pippenger(*(torch.from_numpy(a) for a in (x, y, digits)), 4)

    def jax_msm(x, y, d):
        one = jnp.broadcast_to(jnp.asarray(Jf.ONE_MONT),
                               x.shape).astype(jnp.int32)
        return Jc.pt_msm_pippenger(Jc.F1, (x, y, one), d, 4)

    want = jax.jit(jax_msm)(x, y, digits)
    for g, w in zip(got, want):
        assert g.shape == (33,) and np.array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("algo", ["pippenger", "double-add"])
def test_g1_multi_exp_device_matches_the_oracle(algo):
    pts, ks = _probe(6)
    pts += [C.g1.mul(C.G1_GEN, 7), C.g1.infinity()]
    ks += [0, 12345]
    got = TB.g1_multi_exp_device(pts, ks, device="cpu", algo=algo)
    assert C.g1.eq_points(got, C.g1.msm(pts, ks))
    assert C.g1.is_inf(TB.g1_multi_exp_device([C.G1_GEN], [0],
                                              device="cpu"))


def test_multi_exp_routes_16_points_to_the_device(monkeypatch):
    calls = []
    real = TB.g1_multi_exp_device

    def spy(points, scalars, device="cuda", **kw):
        calls.append((len(points), device))
        return real(points, scalars, device=device, **kw)

    monkeypatch.setattr(TB, "g1_multi_exp_device", spy)
    monkeypatch.setattr(TBLS, "_device", "cpu")
    saved = TBLS.backend_name()
    try:
        TBLS.use_backend("torch")
        for n in (15, 16):
            pts, ks = _probe(n)
            got = TBLS.multi_exp([(1, p) for p in pts], ks)
            assert got[0] == 1 and C.g1.eq_points(got[1], C.g1.msm(pts, ks))
        assert calls == [(16, "cpu")]
        TBLS.use_backend("py")
        TBLS.multi_exp([(1, p) for p in _probe(16)[0]], _probe(16)[1])
        assert calls == [(16, "cpu")]
    finally:
        TBLS.use_backend(saved)
