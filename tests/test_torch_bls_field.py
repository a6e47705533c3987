"""The port's Fq and tower arithmetic (plain versions of rows 7-8, the
arithmetic of kernels K7-K10) against `consensus_specs_tpu.ops.bls_batch`
`fq` and `tower`, limb for limb, tolerance zero.  Inputs are canonical
random elements, signed-lazy limb vectors and edge values (0, 1, p - 1,
p), made from numpy and `random.Random` seeds; each JAX function is
jitted once per shape and its output memoized."""

import random

import jax
import numpy as np
import pytest
import torch

from consensus_specs_tpu.ops.bls import fields as jax_fields
from consensus_specs_tpu.ops.bls_batch import fq as Jf
from consensus_specs_tpu.ops.bls_batch import tower as Jt
from consensus_specs_tpu_torch.ops.bls.fields import Q
from consensus_specs_tpu_torch.ops.bls_batch import fq as F
from consensus_specs_tpu_torch.ops.bls_batch import kernels as K
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
    """`fn` jitted once under `name`, on numpy inputs -> numpy output."""
    if name not in _JIT:
        _JIT[name] = jax.jit(fn)
    return np.asarray(_JIT[name](*args))


def _torch(fn, *args):
    return fn(*(torch.from_numpy(np.ascontiguousarray(a)) for a in args))


def _rand(shape, seed):
    r = random.Random(seed)
    n = int(np.prod(shape))
    return np.stack([Jf.to_mont(r.randrange(Q)) for _ in range(n)]
                    ).reshape(tuple(shape) + (33,))


def _lazy(shape, seed, bound=2**13):
    """Signed-lazy limb vectors, as the hot path leaves them between
    multiplications."""
    return np.random.RandomState(seed).randint(
        -bound, bound, tuple(shape) + (33,)).astype(np.int32)


EDGE = np.stack([np.zeros(33, np.int32), Jf.ONE_MONT, Jf.int_to_limbs(1),
                 Jf.to_mont(Q - 1), Jf.P_LIMBS, Jf.TWO_P_LIMBS])


def _same(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)


# --- host conversions and constants ------------------------------------------


def test_constants_and_host_conversions_match_jax():
    for name in ("LIMB_BITS", "N_LIMBS", "LIMB_MASK", "R_BITS", "R_MONT",
                 "Q_INV_NEG"):
        assert getattr(F, name) == getattr(Jf, name), name
    for name in ("P_LIMBS", "TWO_P_LIMBS", "ONE_MONT", "_P_MINUS_2_BITS"):
        _same(getattr(F, name), getattr(Jf, name))
    r = random.Random(1)
    for x in [0, 1, Q - 1, 2**381 - 1] + [r.randrange(Q) for _ in range(8)]:
        _same(F.int_to_limbs(x), Jf.int_to_limbs(x))
        _same(F.to_mont(x), Jf.to_mont(x))
        assert F.from_mont(F.to_mont(x)) == x % Q
    lazy = _lazy((1,), 5)
    assert F.limbs_to_int(torch.from_numpy(lazy)) == Jf.limbs_to_int(lazy)


def test_tower_constants_and_oracle_conversions_match_jax():
    for name in ("FQ2_ONE_L", "FQ12_ONE_L"):
        _same(getattr(T, name), getattr(Jt, name))
    _same(T.GAMMA_L, np.stack(Jt._GAMMA_L))
    e = jax_fields.Fq12(
        jax_fields.Fq6(*(jax_fields.Fq2(3 * i + 1, 5 * i + 2)
                         for i in range(3))),
        jax_fields.Fq6(*(jax_fields.Fq2(7 * i + 3, Q - i - 1)
                         for i in range(3))))
    limbs = Jt.fq12_from_oracle(e)
    mine = T.fq12_to_oracle(torch.from_numpy(limbs))
    assert (mine.c0.c0.c0, mine.c1.c2.c1) == (e.c0.c0.c0, e.c1.c2.c1)
    _same(T.fq12_from_oracle(mine), limbs)


def test_kernel_constant_block_derivation():
    """The words `kernels.constant_words` writes into the kernels'
    `__constant__` block: p, p - 2, -p^-1 mod 2^32, the conversion
    factors and the Montgomery forms of the Frobenius and untwist
    constants, re-derived here from the JAX package's oracle, then the
    sliding-window digits of p - 2 and their count."""
    w = K.constant_words().astype(object)
    assert w.shape == (378,)

    def num(off):
        return sum(int(v) << (32 * i) for i, v in enumerate(w[off:off + 12]))

    assert num(0) == Q and num(12) == Q - 2
    assert num(24) == 2**384 % Q
    assert [num(36), num(48), num(60), num(72)] == [
        pow(2, e, Q) for e in (372, 756, 768, 396)]
    assert (int(w[84]) * Q) % 2**32 == 2**32 - 1
    assert int(w[87]) << 32 | int(w[88]) == abs(jax_fields.BLS_X)
    rinv = pow(2**384, -1, Q)
    for i, g in enumerate(jax_fields._GAMMA):
        assert num(89 + 24 * i) * rinv % Q == g.c0
        assert num(101 + 24 * i) * rinv % Q == g.c1
    digits = K.constant_words()[281:377].view(np.int8)[:int(w[377])]
    e = 0
    for d in digits.tolist():
        e = 2 * e + d
    assert e == Q - 2


# --- Fq ------------------------------------------------------------------------


@pytest.mark.parametrize("passes", [1, 2])
def test_fq_carry(passes):
    x = _lazy((16,), 10 + passes, bound=2**20)
    _same(_torch(lambda t: F.fq_carry(t, passes), x),
          _jax(f"carry{passes}", lambda t: Jf.fq_carry(t, passes), x))


@pytest.mark.parametrize("op", ["fq_add", "fq_sub", "fq_neg", "fq_mul_small"])
def test_fq_linear_ops(op):
    a, b = _lazy((16,), 20), _lazy((16,), 21)
    fns = {"fq_add": (lambda x, y: F.fq_add(x, y), Jf.fq_add),
           "fq_sub": (lambda x, y: F.fq_sub(x, y), Jf.fq_sub),
           "fq_neg": (lambda x, y: F.fq_neg(x), lambda x, y: Jf.fq_neg(x)),
           "fq_mul_small": (lambda x, y: F.fq_mul_small(x, 7),
                            lambda x, y: Jf.fq_mul_small(x, 7))}
    mine, ref = fns[op]
    _same(_torch(mine, a, b), _jax(op, ref, a, b))


@pytest.mark.parametrize("kind", ["random", "lazy", "edge"])
def test_fq_mul(kind):
    if kind == "random":
        a, b = _rand((16,), 30), _rand((16,), 31)
    elif kind == "lazy":
        a, b = _lazy((16,), 32, bound=2**15), _lazy((16,), 33, bound=2**15)
    else:
        a, b = EDGE, EDGE[::-1].copy()
    _same(_torch(F.fq_mul, a, b), _jax(f"fq_mul{kind}", Jf.fq_mul, a, b))


def test_fq_mul_broadcasts():
    a, b = _rand((3, 1), 34), _rand((1, 4), 35)
    _same(_torch(F.fq_mul, a, b), _jax("fq_mul_bc", Jf.fq_mul, a, b))


@pytest.mark.parametrize("kind", ["random", "lazy", "edge"])
def test_fq_canon(kind):
    x = {"random": _rand((16,), 40), "lazy": _lazy((16,), 41),
         "edge": np.concatenate([EDGE, -EDGE, 3 * EDGE])}[kind]
    got = _torch(F.fq_canon, x)
    _same(got, _jax(f"canon{kind}", Jf.fq_canon, x))
    assert ((got >= 0) & (got < 4096)).all()


def test_fq_is_zero_and_eq():
    x = np.concatenate([EDGE, _lazy((4,), 42)])
    _same(_torch(F.fq_is_zero, x), _jax("is_zero", Jf.fq_is_zero, x))
    y = np.concatenate([EDGE[[4, 0, 2, 1, 3, 5]], _lazy((4,), 42)])
    _same(_torch(F.fq_eq, x, y), _jax("fq_eq", Jf.fq_eq, x, y))
    assert _torch(F.fq_is_zero, x).tolist()[:6] == [True, False, False,
                                                    False, True, True]


def test_fq_pow_const():
    bits = np.array([1, 0, 1, 1, 0, 0, 1], dtype=np.int32)
    a = _rand((8,), 43)
    _same(_torch(lambda t: F.fq_pow_const(t, bits), a),
          _jax("pow", lambda t: Jf.fq_pow_const(t, bits), a))


def test_fq_inv_random_and_zero():
    a = np.concatenate([_rand((6,), 44), EDGE[:4], _lazy((2,), 45)])
    got = _torch(F.fq_inv, a)
    _same(got, _jax("fq_inv", Jf.fq_inv, a))
    canon = F.fq_canon(got).numpy()
    assert not canon[6].any()                  # inv(0) = 0
    for i in (0, 1, 7, 8):
        assert F.from_mont(canon[i]) * F.from_mont(a[i]) % Q == 1


# --- the tower -----------------------------------------------------------------


def _elems(kind, shape, seed):
    return _rand(shape, seed) if kind == "random" else _lazy(shape, seed)


@pytest.mark.parametrize("kind", ["random", "lazy"])
@pytest.mark.parametrize("op", ["fq2_mul", "fq2_sqr", "fq2_mul_xi",
                                "fq2_conj", "fq2_mul_fq"])
def test_fq2_ops(op, kind):
    a, b = _elems(kind, (6, 2), 50), _elems(kind, (6, 2), 51)
    s = _elems(kind, (6,), 52)
    fns = {"fq2_mul": (T.fq2_mul, Jt.fq2_mul, (a, b)),
           "fq2_sqr": (T.fq2_sqr, Jt.fq2_sqr, (a,)),
           "fq2_mul_xi": (T.fq2_mul_xi, Jt.fq2_mul_xi, (a,)),
           "fq2_conj": (T.fq2_conj, Jt.fq2_conj, (a,)),
           "fq2_mul_fq": (T.fq2_mul_fq, Jt.fq2_mul_fq, (a, s))}
    mine, ref, args = fns[op]
    _same(_torch(mine, *args), _jax(f"{op}{kind}", ref, *args))


def test_fq2_inv_including_zero():
    a = _rand((4, 2), 53)
    a[0] = 0
    a[1, 1] = 0                               # a real element
    got = _torch(T.fq2_inv, a)
    _same(got, _jax("fq2_inv", Jt.fq2_inv, a))
    assert not F.fq_canon(got[0]).any()
    _same(_torch(T.fq2_is_zero, a), _jax("fq2_is_zero", Jt.fq2_is_zero, a))


@pytest.mark.parametrize("op", ["fq6_mul", "fq6_mul_by_v", "fq6_inv"])
def test_fq6_ops(op):
    a, b = _rand((3, 3, 2), 60), _rand((3, 3, 2), 61)
    fns = {"fq6_mul": (T.fq6_mul, Jt.fq6_mul, (a, b)),
           "fq6_mul_by_v": (T.fq6_mul_by_v, Jt.fq6_mul_by_v, (a,)),
           "fq6_inv": (T.fq6_inv, Jt.fq6_inv, (a,))}
    mine, ref, args = fns[op]
    _same(_torch(mine, *args), _jax(op, ref, *args))


@pytest.mark.parametrize("kind", ["random", "lazy"])
@pytest.mark.parametrize("op", ["fq12_mul", "fq12_sqr", "fq12_conj"])
def test_fq12_ops(op, kind):
    a, b = _elems(kind, (3, 2, 3, 2), 70), _elems(kind, (3, 2, 3, 2), 71)
    fns = {"fq12_mul": (T.fq12_mul, Jt.fq12_mul, (a, b)),
           "fq12_sqr": (T.fq12_sqr, Jt.fq12_sqr, (a,)),
           "fq12_conj": (T.fq12_conj, Jt.fq12_conj, (a,))}
    mine, ref, args = fns[op]
    _same(_torch(mine, *args), _jax(f"{op}{kind}", ref, *args))


def test_fq12_inv_including_zero():
    a = _rand((3, 2, 3, 2), 72)
    a[0] = 0
    got = _torch(T.fq12_inv, a)
    _same(got, _jax("fq12_inv", Jt.fq12_inv, a))
    assert not F.fq_canon(got[0]).any()


@pytest.mark.parametrize("power", [1, 2, 6])
def test_fq12_frobenius(power):
    a = _rand((2, 2, 3, 2), 80 + power)
    got = _torch(lambda t: T.fq12_frobenius(t, power), a)
    _same(got, _jax(f"frob{power}", lambda t: Jt.fq12_frobenius(t, power), a))
    # the q^power map of the JAX package's oracle
    e = Jt.fq12_to_oracle(a[0])
    _same(F.fq_canon(got[0]), Jt.fq12_from_oracle(e.frobenius(power)))


def test_fq12_is_one_and_w_coeffs():
    a = np.stack([_rand((2, 3, 2), 90), Jt.FQ12_ONE_L,
                  Jt.FQ12_ONE_L + Jf.P_LIMBS * (np.arange(2 * 3 * 2)
                                                 .reshape(2, 3, 2, 1) % 2)]
                 ).astype(np.int32)
    _same(_torch(T.fq12_is_one, a), _jax("is_one", Jt.fq12_is_one, a))
    assert _torch(T.fq12_is_one, a).tolist() == [False, True, True]
    t = torch.from_numpy(a)
    assert torch.equal(T._from_w_coeffs(T._w_coeffs(t)), t)


# --- K7's plain version --------------------------------------------------------


@pytest.mark.parametrize("op", sorted(K.FIELD_OPS))
def test_field_op_plain_is_canonical_jax(op):
    """K7's plain version (the kernels' comparison on the card) is JAX's
    op followed by `fq_canon`."""
    dims = K.FIELD_OPS[op][1]
    shape = {1: (6,), 2: (3, 2), 4: (1, 2, 3, 2)}[dims]
    a, b = _rand(shape, 100), _rand(shape, 101)
    ref = {"fq_mul": lambda x, y: Jf.fq_mul(x, y),
           "fq_inv": lambda x, y: Jf.fq_inv(x),
           "fq_canon": lambda x, y: x,
           "fq2_mul": Jt.fq2_mul, "fq2_inv": lambda x, y: Jt.fq2_inv(x),
           "fq12_mul": Jt.fq12_mul, "fq12_sqr": lambda x, y: Jt.fq12_sqr(x),
           "fq12_inv": lambda x, y: Jt.fq12_inv(x),
           "fq12_frobenius": lambda x, y: Jt.fq12_frobenius(x, 2),
           "fq_add": Jf.fq_add, "fq_sub": Jf.fq_sub}[op]
    got = K.field_op(op, torch.from_numpy(a), torch.from_numpy(b), k=2)
    _same(got, _jax(f"k7{op}", lambda x, y: Jf.fq_canon(ref(x, y)), a, b))
