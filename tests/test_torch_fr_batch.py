"""Slice 5 of the port, the scalar-field kernels' plain versions against
the JAX package's `ops/fr_batch.py` (tolerance zero): `barycentric_eval`
(K16's plain version) at W = 8 and 64 over the classic domain and a coset,
against JAX's and the spec's loop; `coset_interpolate_sum` (K17's) on a
3-cell batch at rung 16 against JAX's and the host fold; `fr_fft`
(K18's), forward and inverse at n = 8 and 128 on a batch of 2, against
JAX's and the host `_fft`.  Each stage's limbs equal JAX's program's on
the same inputs.  The kernels are held against these plain versions on
the card (`tests/test_torch_cuda.py`, `chip_smoke.py`)."""

import functools
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consensus_specs_tpu.das import ciphersuite as Jcs
from consensus_specs_tpu.das import compute as Jcompute
from consensus_specs_tpu.das import verify as Jverify
from consensus_specs_tpu.ops import fr_batch as J
from consensus_specs_tpu_torch.das import ciphersuite as Tcs
from consensus_specs_tpu_torch.das import compute as Tcompute
from consensus_specs_tpu_torch.das import verify as Tverify
from consensus_specs_tpu_torch.ops import fr_batch as T

R = J.R_MODULUS


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions are thousands of small int32 ops: one intra-op
    thread runs them faster than a pool of one thread per core, and
    keeps parallel test workers from oversubscribing the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _roots(n):
    g = pow(7, (R - 1) // n, R)
    return [pow(g, i, R) for i in range(n)]


def _brp(xs):
    n = len(xs)
    return [xs[Tcs.reverse_bits(i, n)] for i in range(n)]


def _spec_loop(poly, domain, z, h):
    """The spec's evaluation loop, generalized to the coset h G:
    (z^W - h^W) / (W h^W) * sum_i f_i x_i / (z - x_i)."""
    width = len(poly)
    acc = 0
    for f, x in zip(poly, domain):
        acc = (acc + f * x * pow(z - x, R - 2, R)) % R
    hw = pow(h, width, R)
    return acc * (pow(z, width, R) - hw) * pow(width * hw, R - 2, R) % R


@pytest.mark.parametrize("width,shift", [(8, 1), (8, 5), (64, 1),
                                         (64, 0x1234567)])
def test_barycentric_eval_matches_jax_and_the_spec_loop(width, shift):
    rng = random.Random(width * 31 + shift)
    domain = [shift * r % R for r in _brp(_roots(width))]
    poly = [rng.randrange(R) for _ in range(width)]
    z = rng.randrange(R)
    got = T.barycentric_eval(poly, domain, z, shift_int=shift, device="cpu")
    assert got == J.barycentric_eval(poly, domain, z, shift_int=shift)
    assert got == _spec_loop(poly, domain, z, shift)
    # the stage's limbs equal JAX's program's
    arrays = T.barycentric_inputs(poly, domain, z, shift)
    limbs = T.barycentric(*(torch.from_numpy(a) for a in arrays))
    want = J._barycentric_kernel(width)(*(jnp.asarray(a) for a in arrays))
    assert np.array_equal(limbs.numpy(), np.asarray(want))


def test_barycentric_eval_rejects_a_zero_shift_and_ragged_input():
    with pytest.raises(AssertionError):
        T.barycentric_eval([1, 2], [1, R - 1], 3, shift_int=R, device="cpu")
    with pytest.raises(AssertionError):
        T.barycentric_eval([1, 2, 3], [1, R - 1], 3, device="cpu")


@functools.cache
def _matrix():
    return Tcs.closed_form_matrix(2, columns=[0, 3, 64, 127])


def test_coset_interpolate_sum_matches_jax_at_rung_16():
    com, idx, cells, proofs = _matrix()
    batch = Tcs.parse_cell_batch(com[:3], idx[:3], cells[:3], proofs[:3])
    weights = Tverify._rli_weight_rows(batch)
    idft = Tcs.coset_idft_matrix()
    got = T.coset_interpolate_sum(batch.evals, idft, weights, device="cpu")
    assert got == J.coset_interpolate_sum(batch.evals,
                                          Jcs.coset_idft_matrix(), weights)
    assert got == Tverify._host_rli_coeffs(batch)
    arrays = T.coset_interpolate_inputs(batch.evals, idft, weights)
    assert arrays[0].shape == (16, 64, 33)           # das_rung(3)
    assert not arrays[2][3:].any()                    # pad rows weigh 0
    limbs = T.coset_interpolate(*(torch.from_numpy(a) for a in arrays))
    want = J._coset_interpolate_kernel(16, 64)(
        *(jnp.asarray(a) for a in arrays))
    assert np.array_equal(limbs.numpy(), np.asarray(want))


@pytest.mark.parametrize("n", [8, 128])
@pytest.mark.parametrize("inverse", [False, True])
def test_fr_fft_matches_jax_and_the_host_fft(n, inverse):
    rng = random.Random(n + inverse)
    roots = _roots(n)
    rows = [[rng.randrange(R) for _ in range(n)] for _ in range(2)]
    got = T.fr_fft(rows, roots, inverse=inverse, device="cpu")
    assert got == J.fr_fft(rows, roots, inverse=inverse)
    host = Tcompute._ifft if inverse else Tcompute._fft
    assert got == [host(r, roots) for r in rows]
    assert Tcompute._fft(rows[0], roots) == Jcompute._fft(rows[0], roots)
    arrays = T.fft_inputs(rows, roots, inverse)
    limbs = T.fft(*(torch.from_numpy(a) for a in arrays))
    tws = J._fft_twiddles_mont(tuple(
        ((roots[0],) + tuple(roots[:0:-1])) if inverse else roots))
    want = J._fr_fft_kernel(n, 2)(jnp.asarray(arrays[0]),
                                  tuple(jnp.asarray(t) for t in tws),
                                  jnp.asarray(arrays[2]))
    assert np.array_equal(limbs.numpy(), np.asarray(want))


def test_fft_round_trip_and_limb_readback():
    rng = random.Random(3)
    roots = _roots(16)
    row = [rng.randrange(R) for _ in range(16)]
    coeffs = T.fr_fft([row], roots, inverse=True, device="cpu")[0]
    assert T.fr_fft([coeffs], roots, device="cpu")[0] == row
    # canonical and lazy limbs read back to the same ints
    limbs = torch.from_numpy(T.FR.to_mont_batch(row))
    assert T.from_limbs(limbs) == row
    assert T.from_limbs(T.FR.add(limbs, limbs)) == [2 * v % R for v in row]
    assert Jverify.das_rung(3) == T.das_rung(3) == 16
