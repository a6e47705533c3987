"""Slice 5 of the port, the scalar-field (Fr) layer: every op of the plain
`ops/fr_batch/field.py` against the JAX package's `FR`
(`ops/fr_batch.py:48 PrimeFieldKernel`), limb for limb (tolerance zero),
on seeded random and edge values, lazy inputs included; the canonical
form K15 is compared at; and the carry-over functions of `convert.py`.
The kernel K15 is held against these plain versions on the card
(`tests/test_torch_cuda.py`, `chip_smoke.py`)."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consensus_specs_tpu.ops import fr_batch as J
from consensus_specs_tpu_torch import convert as C
from consensus_specs_tpu_torch.ops import fr_batch as T
from consensus_specs_tpu_torch.ops.fr_batch import field as F

R = J.R_MODULUS
EDGE = [0, 1, 2, R - 1, R - 2, (R - 1) // 2]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions are thousands of small int32 ops: one intra-op
    thread runs them faster than a pool of one thread per core, and
    keeps parallel test workers from oversubscribing the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _values(seed, n=24):
    rng = random.Random(seed)
    return EDGE + [rng.randrange(R) for _ in range(n - len(EDGE))]


def _pair(seed):
    a = T.FR.to_mont_batch(_values(seed))
    b = T.FR.to_mont_batch(_values(seed + 1)[::-1])
    return a, b


def _lazy(seed, shape=(24, 33)):
    """Signed-lazy limbs, as sums and differences leave them."""
    return np.random.RandomState(seed).randint(
        -2**13, 2**13, shape).astype(np.int32)


def _eq(got: torch.Tensor, want) -> bool:
    want = np.asarray(want)
    return got.dtype == torch.int32 and np.array_equal(got.numpy(), want)


def test_constants_and_host_conversions_match_jax():
    assert F.R_MODULUS == R and T.FR.modulus == J.FR.modulus
    assert (F.LIMB_BITS, F.N_LIMBS, F.R_BITS) == (J.LIMB_BITS, J.N_LIMBS,
                                                  J.R_BITS)
    for name in ("r_mont", "q_inv_neg"):
        assert getattr(T.FR, name) == getattr(J.FR, name), name
    for name in ("p_limbs", "two_p_limbs", "one_mont"):
        assert np.array_equal(getattr(T.FR, name), getattr(J.FR, name)), name
    xs = _values(1)
    assert np.array_equal(T.FR.to_mont_batch(xs), J.FR.to_mont_batch(xs))
    for x in xs:
        assert np.array_equal(T.FR.int_to_limbs(x), J.FR.int_to_limbs(x))
        assert np.array_equal(T.FR.to_mont(x), J.FR.to_mont(x))
        m = J.FR.to_mont(x)
        assert T.FR.from_mont(m) == J.FR.from_mont(m) == x
        assert T.FR.limbs_to_int(torch.from_numpy(m)) == J.FR.limbs_to_int(m)
    lazy = _lazy(2)
    assert T.FR.from_mont_batch(lazy) == [J.FR.from_mont(r) for r in lazy]


@pytest.mark.parametrize("passes", [1, 2])
def test_carry_matches_jax(passes):
    x = _lazy(3)
    got = T.FR.carry(torch.from_numpy(x), passes)
    assert _eq(got, J.FR.carry(jnp.asarray(x), passes))


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_binary_ops_match_jax(op):
    a, b = _pair(4)
    got = getattr(T.FR, op)(torch.from_numpy(a), torch.from_numpy(b))
    assert _eq(got, getattr(J.FR, op)(jnp.asarray(a), jnp.asarray(b)))
    # lazy operands (as a barycentric or FFT stage feeds them)
    la, lb = _lazy(5), _lazy(6)
    got = getattr(T.FR, op)(torch.from_numpy(la), torch.from_numpy(lb))
    assert _eq(got, getattr(J.FR, op)(jnp.asarray(la), jnp.asarray(lb)))


def test_mul_broadcasts_like_jax():
    a = T.FR.to_mont_batch(_values(7, 6)).reshape(2, 3, 1, 33)
    b = T.FR.to_mont_batch(_values(8)[-4:]).reshape(1, 4, 33)
    got = T.FR.mul(torch.from_numpy(a), torch.from_numpy(b))
    assert got.shape == (2, 3, 4, 33)
    assert _eq(got, J.FR.mul(jnp.asarray(a), jnp.asarray(b)))


def test_inv_matches_jax_and_zero_maps_to_zero():
    a = T.FR.to_mont_batch(_values(9, 12))
    got = T.FR.inv(torch.from_numpy(a))
    assert _eq(got, J.FR.inv(jnp.asarray(a)))
    vals = T.FR.from_mont_batch(got)
    assert vals[0] == 0                              # inv(0) = 0
    assert all(v * x % R == 1 for v, x in zip(vals[1:], _values(9, 12)[1:]))


@pytest.mark.parametrize("exponent", [0, 1, 64, 4096, 2**64 + 3])
def test_pow_uint_matches_jax(exponent):
    a = T.FR.to_mont_batch(_values(10, 8))
    got = T.FR.pow_uint(torch.from_numpy(a), exponent)
    assert _eq(got, J.FR.pow_uint(jnp.asarray(a), exponent))


@pytest.mark.parametrize("n", [1, 5, 16, 100])
def test_tree_sum_matches_jax(n):
    xs = _values(11, n) if n >= len(EDGE) else _values(11)[:n]
    a = T.FR.to_mont_batch(xs)
    got = T.FR.tree_sum(torch.from_numpy(a), n)
    assert _eq(got, J.FR.tree_sum(jnp.asarray(a), n))
    assert T.FR.from_mont(got.numpy()) == sum(xs) % R


def test_canon_is_the_unique_canonical_form():
    lazy = torch.from_numpy(_lazy(12))
    got = T.FR.canon(lazy)
    assert ((got >= 0) & (got < 4096)).all()
    vals = T.FR.from_mont_batch(lazy)
    assert T.FR.from_mont_batch(got) == vals
    assert _eq(got, T.FR.to_mont_batch(vals))
    assert torch.equal(T.FR.canon(got), got)


@pytest.mark.parametrize("op", ["mul", "add", "sub", "inv", "pow", "canon"])
def test_field_op_plain_against_python_ints(op):
    """K15's plain version (the op, then `canon`) against int arithmetic,
    on random and edge values."""
    xs, ys = _values(13), _values(14)[::-1]
    a = C.fr_ints_to_torch(xs, "cpu")
    b = C.fr_ints_to_torch(ys, "cpu")
    e = 12345
    want = {"mul": [x * y % R for x, y in zip(xs, ys)],
            "add": [(x + y) % R for x, y in zip(xs, ys)],
            "sub": [(x - y) % R for x, y in zip(xs, ys)],
            "inv": [pow(x, R - 2, R) for x in xs],
            "pow": [pow(x, e, R) for x in xs],
            "canon": xs}[op]
    got = T.field_op(op, a, b if op in ("mul", "add", "sub") else None, e)
    assert T.from_limbs(got) == want
    assert _eq(got, T.FR.to_mont_batch(want))        # canonical limbs


def test_das_rung_matches_jax():
    for n in (1, 2, 16, 17, 128, 129, 1024, 1025, 4096):
        assert T.das_rung(n) == J.das_rung(n), n


def test_convert_carries_jax_limbs_and_ints_across():
    xs = _values(15)
    jl = J.FR.to_mont_batch(xs)
    t = C.fr_limbs_to_torch(jl, "cpu")
    assert _eq(t, jl) and t.device.type == "cpu"
    assert _eq(C.fr_ints_to_torch(xs, "cpu"), jl)
    assert T.from_limbs(t) == xs
    lazy = _lazy(16, (2, 3, 33))
    assert T.from_limbs(C.fr_limbs_to_torch(lazy, "cpu")) == [
        J.FR.from_mont(r) for r in lazy.reshape(-1, 33)]
    with pytest.raises(AssertionError):
        C.fr_limbs_to_torch(np.zeros((2, 32), np.int32), "cpu")
