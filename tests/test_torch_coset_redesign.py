"""The schedule of the redesigned K17 (`fr_coset_interpolate`) against the
JAX package, on the CPU, tolerance zero (exact arithmetic on Python
ints and numpy words).

The kernel (`csrc/fr_batch.cu`) runs two launches:

- the load launch packs each input's limbs into its value v = x 2^396 mod
  r (canonical);
- the fold launch tiles (rows b, columns j, inner indices i) as
  `kernels.coset_shape` says; a thread sums, for two rows of one column,
  the raw 512-bit products v(e) v(M) of its inner tile lazily (`lazy_mad`:
  16 words and the carries of each row's chains counted apart), reduces
  the sum once (`lazy_reduce`: the word above 2^512 folded in twice as
  its multiple of 2^512 mod r, a Montgomery reduction, three conditional
  subtractions) and multiplies it by v(w) (a Montgomery product); the
  block sums its rows, and the last block the blocks' partials; two
  products by 2^116 (each 2^-140 in Montgomery form) give S_j 2^396.

Here `_lazy_mad_words` replays `lazy_mad`'s chains word by word on numpy
and `_lazy_reduce_words` `lazy_reduce`'s, against Python's integers, on
random words and on the largest sums; `_replay` runs the whole schedule
(its tiles, the one reduction of each sum, the partials) and equals
JAX's `_coset_interpolate_kernel` and the port's plain version at B = 16
and 128 (3 and 100 live cells, the rest padded with zero weights), JAX's
at B = 1024, and the integers at B = 1024 with every input r - 1 (the
sums' largest values).  The kernel itself is held against the plain
version on the card (`tests/test_torch_cuda.py`, `chip_smoke.py`);
`kernels.py`'s constants are held against the CUDA source here."""

import operator
import random
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from consensus_specs_tpu.ops import fr_batch as J
from consensus_specs_tpu_torch.ops import fr_batch as T
from consensus_specs_tpu_torch.ops.fr_batch import kernels as K

R = J.R_MODULUS
R_INV = pow(1 << 256, -1, R)
C_TOP = (1 << 512) % R
N0 = (-pow(R, -1, 1 << 32)) % (1 << 32)
SOURCE = Path(T.__file__).resolve().parents[2] / "csrc" / "fr_batch.cu"
MASK = (1 << 32) - 1


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _constant(name):
    m = re.search(rf"constexpr int {name} = (\d+);", SOURCE.read_text())
    assert m, name
    return int(m.group(1))


def test_kernel_constants_match_the_source():
    assert K.COSET_THREADS == _constant("kCosetThreads")
    assert K.COSET_WIDTH == _constant("kCosetWidth")
    assert K.COSET_COLS == _constant("kCosetCols")
    assert K.COSET_INNER == _constant("kCosetInner")
    assert K.COSET_MIN_INNER == _constant("kCosetMinInner")
    assert K.COSET_FILL == _constant("kCosetFill")


@pytest.mark.parametrize("B,W,want", [
    (1024, 64, (32, 16, 64, 128)), (128, 64, (32, 16, 8, 128)),
    (16, 64, (32, 16, 4, 32)), (5, 8, (8, 64, 4, 2)), (7, 1, (1, 512, 1, 1)),
    (4, 256, (32, 16, 16, 128))])
def test_tiles(B, W, want):
    s = K.coset_shape(B, W)
    assert (s["tj"], s["tb"], s["ic"], s["blocks"]) == want
    assert s["tb"] * s["tj"] == K.COSET_THREADS


# --- the lazy sum, word by word ---------------------------------------------


def _words(x, n):
    return [(x >> (32 * k)) & MASK for k in range(n)]


def _lazy_mad_words(a, b):
    """`lazy_mad` over a batch: a, b (K, N, 8) uint64 words (< 2**32) ->
    (acc (N, 16), cy (N, 9)) after the K products of each column, each
    row's low chain then its high chain with the carry out counted."""
    n = a.shape[1]
    acc = np.zeros((n, 16), np.uint64)
    cy = np.zeros((n, 9), np.uint64)
    for k in range(a.shape[0]):
        for i in range(8):
            for half, base, slot in ((0, i, i), (1, i + 1, i + 1)):
                c = np.zeros(n, np.uint64)
                for j in range(8):
                    p = a[k, :, i] * b[k, :, j]
                    part = (p >> np.uint64(32)) if half else (p & np.uint64(MASK))
                    t = acc[:, base + j] + part + c
                    acc[:, base + j] = t & np.uint64(MASK)
                    c = t >> np.uint64(32)
                cy[:, slot] += c
    return acc, cy


def _value(acc, cy):
    return (sum(int(acc[k]) << (32 * k) for k in range(16))
            + sum(int(cy[m]) << (32 * (m + 8)) for m in range(9)))


def _lazy_reduce_words(v_int):
    """`lazy_reduce` on words: V -> V 2^-256 mod r, checking each bound
    the kernel's word counts rely on."""
    v = _words(v_int, 17)
    assert v_int < 1 << 544
    for _ in range(2):
        h, c = v[16], 0
        for j in range(16):
            c += v[j] + (h * _words(C_TOP, 8)[j] if j < 8 else 0)
            v[j], c = c & MASK, c >> 32
        v[16] = c
        assert c < 1 << 32
    assert v[16] == 0
    mod = _words(R, 8)
    for k in range(8):
        m, c = (v[k] * N0) & MASK, 0
        for j in range(17 - k):
            c += v[k + j] + (m * mod[j] if j < 8 else 0)
            v[k + j], c = c & MASK, c >> 32
        assert c == 0
    t = sum(v[8 + j] << (32 * j) for j in range(9))
    assert t < (1 << 256) + R
    for _ in range(3):
        if t >= R:
            t -= R
    assert t < R
    return t


def test_lazy_mad_words_equal_the_integer_sums():
    rng = np.random.RandomState(5)
    for k_terms in (1, 4, 64, 256):
        a = rng.randint(0, 2 ** 32, (k_terms, 6, 8)).astype(np.uint64)
        b = rng.randint(0, 2 ** 32, (k_terms, 6, 8)).astype(np.uint64)
        a[:, 0], b[:, 0] = MASK, MASK                 # every word 2^32 - 1
        a[:, 1], b[:, 1] = np.array(_words(R - 1, 8)), np.array(_words(R - 1, 8))
        acc, cy = _lazy_mad_words(a, b)
        num = lambda w: sum(int(w[j]) << (32 * j) for j in range(8))
        for col in range(6):
            want = sum(num(a[k, col]) * num(b[k, col])
                       for k in range(k_terms))
            assert _value(acc[col], cy[col]) == want
            assert int(cy[col].max()) <= 2 * k_terms


@pytest.mark.parametrize("v", [
    0, 1, R - 1, (R - 1) ** 2, 64 * (R - 1) ** 2, 256 * ((1 << 256) - 1) ** 2,
    (1 << 544) - 1, 12345678901234567890 ** 8])
def test_lazy_reduce_words(v):
    assert _lazy_reduce_words(v) == v * R_INV % R


# --- the whole schedule -----------------------------------------------------


_LIMB_WEIGHTS = np.array([1 << (12 * k) for k in range(33)], dtype=object)


def _values(limbs):
    """The load launch: each (33,) row's value v = x 2^396 mod r, as an
    object array of the rows' shape."""
    flat = np.asarray(limbs).reshape(-1, 33).astype(np.int64).astype(object)
    return (flat @ _LIMB_WEIGHTS % R).reshape(np.asarray(limbs).shape[:-1])


def _reduce(v):
    """`lazy_reduce` on the integer (`test_lazy_reduce_words` holds the
    two equal): V 2^-256 mod r, V below 2^(512 + 9)."""
    assert v < 1 << 521
    v = (v & ((1 << 512) - 1)) + (v >> 512) * C_TOP
    if v >> 512:
        v = v - (1 << 512) + C_TOP
    m = (-v * pow(R, -1, 1 << 256)) % (1 << 256)
    t = (v + m * R) >> 256
    assert t < (1 << 256) + R
    while t >= R:
        t -= R
    return t


def _replay(evals, idft, weights):
    """K17's schedule on ints: the output values S_j 2^396 mod r.  Each
    inner tile c's lazy sums (the rows' raw products over its ic indices)
    are one object matrix product, reduced once a sum; each fold block's
    partial is the sum of its tb rows; the last block's the sum of the
    blocks'."""
    B, W = evals.shape[0], evals.shape[1]
    sh = K.coset_shape(B, W)
    tb, ic = sh["tb"], sh["ic"]
    ict, bt = W // ic, -(-B // tb)
    assert bt * (W // sh["tj"]) * ict == sh["blocks"]
    ev, wt, mt = _values(evals), _values(weights), _values(idft)
    reduce = np.vectorize(_reduce, otypes=[object])
    pad = np.zeros((bt * tb - B, W), dtype=object)
    partials = []
    for c in range(ict):
        ins = slice(c * ic, (c + 1) * ic)
        terms = reduce(ev[:, ins] @ mt[ins, :]) * wt * R_INV % R
        rows = np.concatenate([terms, pad]).reshape(bt, tb, W)
        partials.append(rows.sum(axis=1) % R)           # a block's rows
    k = pow(2, 116, R) * R_INV                    # Montgomery by c_lo
    return [int(x) for x in sum(p.sum(axis=0) for p in partials) * k * k % R]


def _limb_values(limbs):
    return [sum(int(row[k]) << (12 * k) for k in range(33)) % R
            for row in np.asarray(limbs).reshape(-1, 33)]


def _inputs(n, B, W, kind, seed):
    rng = random.Random(seed)
    if kind == "random":
        rows = lambda m: [[rng.randrange(R) for _ in range(W)]
                          for _ in range(m)]
        arrays = T.coset_interpolate_inputs(rows(n), rows(W), rows(n))
    elif kind == "r-1":
        full = lambda m: [[R - 1] * W for _ in range(m)]
        arrays = T.coset_interpolate_inputs(full(n), full(W), full(n))
    else:                              # limbs whose value is r - 1
        row = np.array([((R - 1) >> (12 * k)) & 0xFFF for k in range(33)],
                       dtype=np.int32)
        arrays = (np.broadcast_to(row, (B, W, 33)).copy(),
                  np.broadcast_to(row, (W, W, 33)).copy(),
                  np.broadcast_to(row, (B, W, 33)).copy())
    assert arrays[0].shape == (B, W, 33)
    return arrays


def _jax(arrays):
    import jax.numpy as jnp

    B, W = arrays[0].shape[:2]
    return _limb_values(J._coset_interpolate_kernel(B, W)(
        *(jnp.asarray(a) for a in arrays)))


@pytest.mark.parametrize("n,B,kind", [
    (3, 16, "random"), (16, 16, "r-1"), (16, 16, "packed"),
    (100, 128, "random")])
def test_schedule_equals_jax_and_the_plain_version(n, B, kind):
    arrays = _inputs(n, B, 64, kind, seed=B + n)
    if kind == "random":
        assert not arrays[2][n:].any()            # pad rows weigh 0
    got = _replay(*arrays)
    assert got == _jax(arrays)
    assert got == _limb_values(T.coset_interpolate_plain(
        *(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)))


def test_schedule_equals_jax_at_rung_1024():
    arrays = _inputs(1000, 1024, 64, "random", seed=1024)
    assert _replay(*arrays) == _jax(arrays)


@pytest.mark.parametrize("kind", ["r-1", pytest.param(
    "packed", marks=pytest.mark.slow)])
def test_schedule_at_rung_1024_with_every_input_r_minus_1(kind):
    """Every input r - 1 (as a field element, and as limbs of value r - 1)
    at B = 1024, where the fold's inner tile is 64 long: each output is
    the integers' B W (r - 1)^3."""
    arrays = _inputs(1024, 1024, 64, kind, seed=0)
    x = (R - 1) * pow(2, -396, R) % R if kind == "packed" else R - 1
    want = 1024 * 64 * x ** 3 % R * pow(2, 396, R) % R
    assert _replay(*arrays) == [want] * 64


@pytest.mark.slow
def test_schedule_equals_the_plain_version_at_rung_1024():
    arrays = _inputs(1000, 1024, 64, "random", seed=1024)
    assert _replay(*arrays) == _limb_values(T.coset_interpolate_plain(
        *(torch.from_numpy(a) for a in arrays)))
