"""The algebra of the redesigned kernels K19 (`g1_fft`) and K20
(`fk20_hext`) against the JAX package, on the CPU, tolerance zero (exact
finite-field arithmetic; limbs compared after canonicalization).

- (a) The general addition's group rounds (`pt_gadd_operands`,
  `pt_gadd_finish` in `csrc/bls_point_passes.cuh`), replayed round by
  round on the port's plain Fq limbs (each round's operands picked before
  its products, the products canonical), with the doubling pass where
  T = Q, give the X3, Y3, Z3 of JAX's `curve_jax.pt_add` on seeded pairs,
  P + P, P + (-P), infinity + Q, P + infinity, infinity + infinity, equal
  Z, Z2 = 1 and infinities under a point's X and Y.
- (b) K19's lane chain, replayed in the kernel's order on the same
  passes over Python ints mod q (the multiples of v up to the top digit;
  from the first nonzero window T[digit], then four doublings and an
  addition a window; no work on a point at infinity), equals JAX's
  `_windowed_mul` for seeded twiddles, the twiddle 1 and an all-zero digit
  row; whole transforms replayed so (the butterfly's u + t and u - t, the
  inverse's 1/n from its leading bit) equal `g1fft_jax.g1_fft_device` at
  n = 8 and 16, forward and inverse, on rows with infinities and masked
  lanes (Z = 0 under a point's X and Y), the inverse on the forward
  output: its last round meets u - t = 2u, the doubling branch.
- (c) K20's replay (the rows in order into 16 buckets a window, the
  suffix sum, the combine most significant first) equals
  `_fk20_hext_kernel` through `fk20_hext_device` at 8 residues x 4
  positions with zero digits, a position of zero scalars, a doubled
  bucket, a point beside its negative and infinities.

A point at infinity's X and Y are read by nobody, and the kernels skip
the work that JAX spends on them, so where Z = 0 only the flag is
compared (as `chip_smoke.py`'s `_same_points` does); (a) compares every
coordinate.  The kernels themselves are held against the plain versions
on the card (`tests/test_torch_cuda.py`, `chip_smoke.py`).  The file
takes about 180 s on one core, nearly all of it JAX compiling: each of
the four transforms about 30 s, `_windowed_mul` 21 s, the hext MSM 19 s;
the replays take a few seconds."""

import functools
import random

import jax
import numpy as np
import pytest
import torch

from consensus_specs_tpu.ops.bls_batch import curve_jax as Jc
from consensus_specs_tpu.ops.bls_batch import g1fft_jax as Jgf
from consensus_specs_tpu_torch.ops.bls import curve as Cv
from consensus_specs_tpu_torch.ops.bls.fields import Q
from consensus_specs_tpu_torch.ops.bls_batch import fq as F
from consensus_specs_tpu_torch.ops.bls_batch import g1fft as G
from consensus_specs_tpu_torch.ops.bls_batch.curve import scalars_to_digits

R = G.R_MODULUS


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain limb ops are many small int32 ops: one intra-op thread
    runs them faster than a pool of one thread per core, and keeps
    parallel test workers from oversubscribing the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# --- the kernels' fields -------------------------------------------------------


class IntFp:
    """Fq on Python ints mod q: the kernels' canonical values (their
    Montgomery factor divides out)."""

    one, zero = 1, 0

    @staticmethod
    def add(a, b):
        return (a + b) % Q

    @staticmethod
    def sub(a, b):
        return (a - b) % Q

    @staticmethod
    def is_zero(a):
        return a % Q == 0

    @staticmethod
    def mul_round(pairs):
        return [a * b % Q for a, b in pairs]


class LimbFp:
    """Fq on the port's plain limbs (one element a tensor (33,)): sums
    lazy, products canonical, as the kernels' products are."""

    one = F.const(F.to_mont(1), "cpu")
    zero = torch.zeros(33, dtype=torch.int32)

    @staticmethod
    def add(a, b):
        return F.fq_add(a, b)

    @staticmethod
    def sub(a, b):
        return F.fq_sub(a, b)

    @staticmethod
    def is_zero(a):
        return bool((F.fq_canon(a) == 0).all())

    @staticmethod
    def mul_round(pairs):
        a = torch.stack([x for x, _ in pairs])
        b = torch.stack([y for _, y in pairs])
        return list(F.fq_canon(F.fq_mul(a, b)).unbind(0))


def _dbl(f, a):
    return f.add(a, a)


# --- the group passes, replayed (bls_point_passes.cuh, g1_fft.cu) --------------

DBL_PRODUCTS = (3, 3, 1)
GADD_PRODUCTS = (3, 4, 4, 3, 2)


def _dbl_operands(f, P, t, k, j):
    """Product j of doubling round k: (a, b, slot), `pt_dbl_operands`."""
    X, Y, Z = P
    if k == 0:
        return (X, Y, Y)[j], (X, Y, Z)[j], ("XX", "YY", "YZ")[j]
    if k == 1:
        if j == 0:
            return t["YY"], t["YY"], "C"
        if j == 1:
            return X, t["YY"], "XYY"
        e = f.add(_dbl(f, t["XX"]), t["XX"])
        return e, e, "F"
    u = _dbl(f, _dbl(f, t["XYY"]))                  # D = 4 X Y^2
    v = f.sub(t["F"], _dbl(f, u))                   # X3 = F - 2D
    return f.add(_dbl(f, t["XX"]), t["XX"]), f.sub(u, v), "EDX"


def _gadd_operands(f, P, Q2, t, k, j):
    """Product j of general-addition round k: (a, b, slot),
    `pt_gadd_operands`."""
    (X1, Y1, Z1), (X2, Y2, Z2) = P, Q2
    if k == 0:
        return ((Z1, Z1, "Z1Z1"), (Z2, Z2, "Z2Z2"), (Z1, Z2, "Z1Z2"))[j]
    if k == 1:
        return ((X1, t["Z2Z2"], "U1"), (X2, t["Z1Z1"], "U2"),
                (t["Z1Z1"], Z1, "Z1C"), (t["Z2Z2"], Z2, "Z2C"))[j]
    if k == 2:
        if j < 2:
            return ((Y1, t["Z2C"], "S1"), (Y2, t["Z1C"], "S2"))[j]
        h = f.sub(t["U2"], t["U1"])
        if j == 2:
            return _dbl(f, h), _dbl(f, h), "I"
        return t["Z1Z2"], h, "ZH"
    if k == 3:
        if j == 0:
            return f.sub(t["U2"], t["U1"]), t["I"], "J"
        if j == 1:
            return t["U1"], t["I"], "V"
        rr = _dbl(f, f.sub(t["S2"], t["S1"]))
        return rr, rr, "RR"
    if j == 0:
        return t["S1"], t["J"], "SJ"
    x3 = f.sub(f.sub(t["RR"], t["J"]), _dbl(f, t["V"]))
    return _dbl(f, f.sub(t["S2"], t["S1"])), f.sub(t["V"], x3), "Y3"


def _rounds(f, operands, counts):
    """Every operand of a round picked from the state before its
    products (the warp barriers), then the round's products."""
    t = {}
    for k, n in enumerate(counts):
        picked = [operands(t, k, j) for j in range(n)]
        for (_, _, slot), v in zip(picked, f.mul_round(
                [(a, b) for a, b, _ in picked])):
            t[slot] = v
    return t


def dbl_pass(f, P):
    """T <- 2T (`g1_dbl`): a T at infinity is left as it is."""
    if f.is_zero(P[2]):
        return P
    t = _rounds(f, lambda t, k, j: _dbl_operands(f, P, t, k, j),
                DBL_PRODUCTS)
    u = _dbl(f, _dbl(f, _dbl(f, t["XYY"])))
    c8 = _dbl(f, _dbl(f, _dbl(f, t["C"])))
    return (f.sub(t["F"], u), f.sub(t["EDX"], c8), _dbl(f, t["YZ"]))


def add_pass(f, P, Q2):
    """T <- T + Q (`g1_add`): the rounds only where T and Q are both
    finite, then `pt_gadd_finish`'s cases in pt_add's order, and a
    doubling pass where T = Q."""
    if f.is_zero(Q2[2]):
        return P
    if f.is_zero(P[2]):
        return tuple(Q2)
    t = _rounds(f, lambda t, k, j: _gadd_operands(f, P, Q2, t, k, j),
                GADD_PRODUCTS)
    if f.is_zero(f.sub(t["U2"], t["U1"])):
        if f.is_zero(f.sub(t["S2"], t["S1"])):
            return dbl_pass(f, P)
        return (f.one, f.one, f.zero)
    x3 = f.sub(f.sub(t["RR"], t["J"]), _dbl(f, t["V"]))
    return (x3, f.sub(t["Y3"], _dbl(f, t["SJ"])), _dbl(f, t["ZH"]))


def lane_mul(f, v, digits):
    """K19's lane: t = k v from the twiddle's window digits."""
    digits = [int(d) for d in digits]
    top = max(digits)
    first = next((w for w, d in enumerate(digits) if d), len(digits))
    T = {1: tuple(v)}
    for d in range(2, top + 1):
        T[d] = (add_pass(f, T[d - 1], T[1]) if d % 2
                else dbl_pass(f, T[d // 2]))
    acc = (f.one, f.one, f.zero)
    for w in range(first, len(digits)):
        if w == first:
            acc = T[digits[w]]
            continue
        for _ in range(4):
            acc = dbl_pass(f, acc)
        if digits[w]:
            acc = add_pass(f, acc, T[digits[w]])
    return acc


def transform(f, rows, n, inverse):
    """K19's whole transform on bit-reversed rows of points: the
    butterfly rounds in place, then the inverse's 1/n on every point."""
    u_all, v_all, d_all = G._stage_plan(n, inverse)
    rows = [list(r) for r in rows]
    for s in range(u_all.shape[0]):
        for row in rows:
            for lane in range(n // 2):
                ui, vi = int(u_all[s][lane]), int(v_all[s][lane])
                t = lane_mul(f, row[vi], d_all[s][lane])
                neg = (t[0], f.sub(f.zero, t[1]), t[2])
                row[ui], row[vi] = (add_pass(f, row[ui], t),
                                    add_pass(f, row[ui], neg))
    if inverse:
        bits = [int(b) for b in G._inv_bits(n)]
        lead = bits.index(1)
        for row in rows:
            for i, p in enumerate(row):
                acc = p
                for b in bits[lead + 1:]:
                    acc = dbl_pass(f, acc)
                    if b:
                        acc = add_pass(f, acc, p)
                row[i] = acc
    return rows


def hext(f, pts, digits):
    """K20's replay at one position: pts (R,) points, digits (R, 64)."""
    inf = (f.one, f.one, f.zero)
    sums = []
    for w in range(digits.shape[1]):
        bk = [inf] * 16
        for i, p in enumerate(pts):
            d = int(digits[i, w])
            if d:
                bk[d] = add_pass(f, bk[d], p)
        running = acc = inf
        for k in range(15, 0, -1):
            running = add_pass(f, running, bk[k])
            acc = add_pass(f, acc, running)
        sums.append(acc)
    res = inf
    for s in sums:
        for _ in range(4):
            res = dbl_pass(f, res)
        res = add_pass(f, res, s)
    return res


# --- helpers ---------------------------------------------------------------------


def _ints(limbs):
    """(..., 33) Montgomery limbs -> nested lists of ints."""
    a = np.asarray(limbs)
    return [F.from_mont(x) for x in a.reshape(-1, 33)]


def _same(got, want, every=False):
    """Replayed points (lists of (x, y, z) ints) against JAX's coordinate
    stacks: the Z = 0 flags, and the coordinates where Z != 0 (all of
    them with `every`)."""
    want = [_ints(F.fq_canon(torch.from_numpy(np.array(c))).numpy())
            for c in want]
    assert len(got) == len(want[0])
    for i, p in enumerate(got):
        w = tuple(c[i] for c in want)
        assert (p[2] % Q == 0) == (w[2] == 0), i
        if every or w[2]:
            assert tuple(c % Q for c in p) == w, i


def _rows(n, batch, seed):
    """Bit-reversed rows of n points: multiples of G1 ending in two
    infinities; row 1 with masked lanes (Z = 0 under a point's X and Y),
    row 2 masked whole.  Limb stacks (batch, n, 33) and int points."""
    rng = random.Random(seed)
    coords = []
    for b in range(batch):
        row = [Cv.g1.mul(Cv.G1_GEN, rng.randrange(1, 2**32))
               for _ in range(n - 2)] + [Cv.g1.infinity()] * 2
        x, y, z = G.points_to_limbs(row)
        for k in {1: (1, n - 3), 2: range(n)}.get(b, ()):
            z[k] = 0
        coords.append((x, y, z))
    perm = list(G._bitrev_perm(n))
    xyz = tuple(np.stack([c[i] for c in coords])[:, perm] for i in range(3))
    return xyz


def _points(xyz):
    """Limb stacks (batch, n, 33) -> rows of int points."""
    X, Y, Z = (np.asarray(c) for c in xyz)
    return [[tuple(F.from_mont(c[b, i]) for c in (X, Y, Z))
             for i in range(X.shape[1])] for b in range(X.shape[0])]


# --- (a) the general addition ----------------------------------------------------

ADD_CASES = ("seeded", "seeded", "P+P", "P+(-P)", "inf+Q", "P+inf",
             "inf+inf", "equal Z", "Z2 = 1", "stale inf+Q", "P+stale inf")


def _jac(p, lam):
    """An oracle point at the Jacobian representative (X l^2, Y l^3, Z l)."""
    x, y, z = Cv.g1.to_affine(p) + (1,)
    return (x * lam * lam % Q, y * lam ** 3 % Q, z * lam % Q)


def _add_cases():
    rng = random.Random(13)
    ps, qs = [], []
    inf = (1, 1, 0)
    for case in ADD_CASES:
        a = Cv.g1.mul(Cv.G1_GEN, rng.randrange(1, R))
        b = Cv.g1.mul(Cv.G1_GEN, rng.randrange(1, R))
        la, lb = rng.randrange(2, Q), rng.randrange(2, Q)
        p, q = _jac(a, la), _jac(b, lb)
        if case == "P+P":
            q = _jac(a, lb)
        elif case == "P+(-P)":
            q = _jac(Cv.g1.neg(a), lb)
        elif case == "inf+Q":
            p = inf
        elif case == "P+inf":
            q = inf
        elif case == "inf+inf":
            p, q = inf, inf
        elif case == "equal Z":
            q = _jac(b, la)
        elif case == "Z2 = 1":
            q = _jac(b, 1)
        elif case == "stale inf+Q":
            p = p[:2] + (0,)
        elif case == "P+stale inf":
            q = q[:2] + (0,)
        ps.append(p)
        qs.append(q)
    return ps, qs


def _limbs(points):
    return tuple(np.stack([F.to_mont(p[i]) for p in points])
                 for i in range(3))


def test_general_addition_rounds_equal_jax_pt_add():
    ps, qs = _add_cases()
    P, Qs = _limbs(ps), _limbs(qs)
    want = jax.jit(lambda p, q: Jc.pt_add(Jc.F1, p, q))(P, Qs)
    got = []
    for i in range(len(ADD_CASES)):
        p = tuple(torch.from_numpy(c[i]) for c in P)
        q = tuple(torch.from_numpy(c[i]) for c in Qs)
        got.append(tuple(_ints(F.fq_canon(c).numpy())[0]
                         for c in add_pass(LimbFp, p, q)))
    _same(got, want, every=True)
    # the cases land where pt_add puts them: P + P doubles, P + (-P) and
    # infinity + infinity are infinity
    assert [g[2] == 0 for g in got] == [c in ("P+(-P)", "inf+inf")
                                        for c in ADD_CASES]
    assert got[2] == tuple(_ints(F.fq_canon(c).numpy())[0] for c in
                           dbl_pass(LimbFp, tuple(torch.from_numpy(c[2])
                                                  for c in P)))


# --- (b) K19 ---------------------------------------------------------------------


def test_lane_chain_equals_jax_windowed_mul():
    rng = random.Random(19)
    lanes = 6
    v = [Cv.g1.mul(Cv.G1_GEN, rng.randrange(1, R)) for _ in range(lanes)]
    v[4] = Cv.g1.infinity()
    scalars = [rng.randrange(R) for _ in range(lanes)]
    scalars[1], scalars[2], scalars[3] = 1, 0, 2**252 + 5
    digs = scalars_to_digits(scalars, 255, 4)
    x, y, z = G.points_to_limbs(v)
    want = jax.jit(Jgf._windowed_mul)((x, y, z), digs)
    pts = _points((x[None], y[None], z[None]))[0]
    got = [lane_mul(IntFp, p, d) for p, d in zip(pts, digs)]
    _same(got, want)
    assert got[1] == pts[1]                     # the twiddle 1 returns v
    assert got[2][2] == 0 and got[4][2] == 0    # 0 v and k infinity


@functools.cache
def _jax_fft(n, batch, inverse, seed):
    x, y, z = _rows(n, batch, seed)
    perm = list(G._bitrev_perm(n))
    nat = tuple(c[:, np.argsort(perm)] for c in (x, y, z))
    out = Jgf.g1_fft_device(*nat, inverse=inverse)
    return (x, y, z), tuple(np.asarray(c) for c in out)


@pytest.mark.parametrize("n,batch,inverse", [(8, 3, False), (16, 2, True)])
def test_transform_equals_jax_g1_fft_device(n, batch, inverse):
    """A forward transform and, on JAX's output of it, the inverse (its
    last round meets u - t = 2u at n = 8: the doubling branch)."""
    xyz, want = _jax_fft(n, batch, inverse, n)
    got = transform(IntFp, _points(xyz), n, inverse)
    _same([p for row in got for p in row],
          tuple(c.reshape(-1, 33) for c in want))
    perm = list(G._bitrev_perm(n))
    back_in = tuple(np.asarray(c)[:, perm] for c in want)
    back = Jgf.g1_fft_device(*want, inverse=not inverse)
    got = transform(IntFp, _points(back_in), n, not inverse)
    _same([p for row in got for p in row],
          tuple(np.asarray(c).reshape(-1, 33) for c in back))


# --- (c) K20 ---------------------------------------------------------------------


def test_hext_replay_equals_jax_fk20_hext():
    rng = random.Random(20)
    n_res, width = 8, 4
    pts = [[Cv.g1.mul(Cv.G1_GEN, rng.randrange(1, R)) for _ in range(width)]
           for _ in range(n_res)]
    scalars = [[rng.randrange(R) for _ in range(width)]
               for _ in range(n_res)]
    pts[5][1], scalars[5][1] = pts[2][1], scalars[2][1]         # doubled
    pts[6][2], scalars[6][2] = Cv.g1.neg(pts[1][2]), scalars[1][2]
    pts[3][0] = Cv.g1.infinity()
    scalars[4][0] = 0
    for row in scalars:
        row[3] = 0                                              # all zero
    x, y, z = (np.stack([[F.to_mont(p[i]) for p in row] for row in pts])
               for i in range(3))
    z[7, 1] = 0                                 # masked: a stale infinity
    want = Jgf.fk20_hext_device(x, y, z, scalars)
    digits = scalars_to_digits([s for row in scalars for s in row], 255,
                               4).reshape(n_res, width, 64)
    cols = _points((x, y, z))
    got = [hext(IntFp, [cols[c][j] for c in range(n_res)], digits[:, j])
           for j in range(width)]
    _same(got, tuple(np.asarray(c) for c in want))
    assert got[3][2] == 0
