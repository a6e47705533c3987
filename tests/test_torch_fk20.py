"""Slice 6 of the port, the FK20 chain as a whole
(`consensus_specs_tpu_torch.das.compute._fk20_proofs_device`) at a toy
shape: L = 4 elements a cell, K = 8 points a residue, N_EXT = 16 cells,
a toy trusted setup [s^i] G.  The port's chain on the CPU (the plain
versions of K18, K15, K20 and K19, the setup tables by one plain G1 FFT,
the gather and mask of row 15' by tensor indexing) must equal the naive
per-coset quotient proofs and JAX's `_fk20_proofs_device` run on the
same toy constants (tolerance zero).  The module globals and the setup
point function are monkeypatched on both sides and the setup caches
cleared; no file of the JAX package changes.  On one x86 core the
port's chain takes about 70 s and JAX's compiles of three G1 FFTs, the
hext MSM and a field FFT about 140 s."""

import functools
import random

import pytest
import torch

from consensus_specs_tpu.das import compute as Jcompute
from consensus_specs_tpu.ops.bls import curve as Jcurve
from consensus_specs_tpu_torch.das import ciphersuite as Tcs
from consensus_specs_tpu_torch.das import compute as Tcompute
from consensus_specs_tpu_torch.ops.bls import curve as Tcurve

L, K, N_EXT = 4, 8, 16
M = L * K
P = Tcs.BLS_MODULUS
SECRET = 0x5EC12E7


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions are thousands of small int32 ops: one intra-op
    thread runs them faster than a pool of one thread per core, and
    keeps parallel test workers from oversubscribing the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@functools.cache
def _setup(curve, t: int):
    return curve.g1.mul(curve.G1_GEN, pow(SECRET, t, P))


@pytest.fixture()
def toy(monkeypatch):
    """The toy constants on both sides, the setup caches cleared before
    and after."""
    for mod, curve in ((Tcompute, Tcurve), (Jcompute, Jcurve)):
        monkeypatch.setattr(mod, "L", L)
        monkeypatch.setattr(mod, "K", K)
        monkeypatch.setattr(mod, "N_EXT", N_EXT)
        monkeypatch.setattr(mod, "M", M)
        monkeypatch.setattr(mod.cs, "setup_g1_point",
                            functools.partial(_setup, curve))
        mod._fk20_setup_tables.cache_clear()
    yield
    Tcompute._fk20_setup_tables.cache_clear()
    Jcompute._fk20_setup_tables.cache_clear()


def _naive_proofs(coeffs):
    """proof_k = [Q_k(s)] with Q_k the quotient of f by X^L - a_k, a_k =
    w_N_EXT^rev(k): the long division of the oracle's multiproof."""
    roots = Tcs.roots_of_unity(N_EXT)
    out = []
    for k in range(N_EXT):
        a = roots[Tcs.reverse_bits(k, N_EXT)]
        rem, q = list(coeffs), [0] * (M - L)
        for i in range(M - 1, L - 1, -1):
            q[i - L] = rem[i]
            rem[i - L] = (rem[i - L] + rem[i] * a) % P
        acc = Tcurve.g1.infinity()
        for t, c in enumerate(q):
            if c:
                acc = Tcurve.g1.add(acc, Tcurve.g1.mul(_setup(Tcurve, t), c))
        out.append(Tcurve.g1_to_bytes(acc))
    return out


def test_toy_fk20_chain_matches_naive_proofs_and_jax(toy):
    rng = random.Random(20)
    coeffs = [rng.randrange(P) for _ in range(M)]
    coeffs[5] = 0
    got = Tcompute._fk20_proofs_device(coeffs, device="cpu")
    assert len(got) == N_EXT
    assert got == _naive_proofs(coeffs)
    assert got == Jcompute._fk20_proofs_device(coeffs)
