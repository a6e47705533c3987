"""The schedules of the redesigned kernels K13 (`msm_pippenger`) and K14
(`msm_double_add`) against the JAX package, on the CPU, tolerance zero
(exact finite-field arithmetic on Python ints mod q).

- (a) K13's schedule, replayed on the group passes of
  `csrc/bls_point_passes.cuh` (the doubling and the general addition,
  round by round, as `tests/test_torch_g1fft_redesign.py` replays them):
  each window's buckets owned by the groups d - 1 = g (mod the group
  count), each group's points in point order with a warp's groups in
  step; the suffix sum's two chains side by side (running += B_k written
  over bucket k, acc one step behind adding running_(k+1) from bucket
  k + 1, both reading the state before the step); the combine most
  significant first, c doublings and an addition a window; no work on a
  point at infinity.  It equals `curve_jax.pt_msm_pippenger` as
  `_msm_pippenger_kernel` runs it at B = 8 with c = 4 and at B = 16 with
  c = 6 and c = 8, on the edge digits: a window of zero digits, every
  point in one bucket, P then P (the doubling branch), Q then -Q
  (infinity mid-chain) and a point after it, zero scalars; and on pairs
  P, -P with equal digits, whose sum is infinity.
- (b) K14's schedule, replayed so (each lane from its leading set bit
  with T = P, then a doubling a bit and an addition of P on each set
  bit; masked lanes at infinity; pt_sum's tree, level m adding lane
  i + m into lane i) equals `_msm_kernel` at B = 16 with masked lanes in
  the middle and at the end, the G1 point (0, 2) of order 3 with
  scalars 3 (T = -Q) and 5 (T = Q), scalars 1, r - 1, 2^254 and 0, and
  a tree level that meets P + P and P + (-P).

Where Z = 0 only the flag is compared: a point at infinity's X and Y are
read by nobody, and the kernels skip the work JAX spends on them.  The
kernels themselves are held against the plain versions on the card
(`tests/test_torch_cuda.py`, `chip_smoke.py`).  The file takes about a
minute on one core, nearly all of it JAX compiling."""

import random

import numpy as np
import pytest
import torch
from test_torch_g1fft_redesign import IntFp, _ints, add_pass, dbl_pass

from consensus_specs_tpu.ops import bls_batch as JB
from consensus_specs_tpu_torch.ops.bls import curve as Cv
from consensus_specs_tpu_torch.ops.bls.fields import Q
from consensus_specs_tpu_torch.ops.bls_batch import curve as BC
from consensus_specs_tpu_torch.ops.bls_batch import fq as F

INF = (1, 1, 0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# --- the schedules, replayed -------------------------------------------------


def window_groups(c):
    """K13's groups a window block (`bls_msm.cu` `window_groups`)."""
    return min(64, max(1, -(-((1 << c) - 1) // 8)) * 8)


def pippenger(pts, digits, c):
    """K13: pts, (x, y, 1) ints; digits (B, W), most significant first."""
    f, nb, G = IntFp, 1 << c, window_groups(c)
    sums = []
    for w in range(digits.shape[1]):
        bk = [INF] * nb
        queues = [[] for _ in range(G)]
        for i, d in enumerate(int(d) for d in digits[:, w]):
            if d:
                queues[(d - 1) % G].append((i, d))
        # a warp's eight groups step through their queues together
        for g0 in range(0, G, 8):
            warp = queues[g0:g0 + 8]
            for s in range(max(len(q) for q in warp)):
                for q in warp:
                    if s < len(q):
                        i, d = q[s]
                        bk[d] = add_pass(f, bk[d], pts[i])
        run = acc = INF
        for s in range(nb):
            k = nb - 1 - s
            step_run = add_pass(f, run, bk[k]) if k >= 1 else run
            if s >= 1:
                acc = add_pass(f, acc, bk[k + 1])
            if k >= 1:
                run = bk[k] = step_run
        sums.append(acc)
    res = INF
    for s in sums:
        for _ in range(c):
            res = dbl_pass(f, res)
        res = add_pass(f, res, s)
    return res


def double_add(pts, bits, mask):
    """K14: each live lane's double-and-add from its leading set bit,
    then pt_sum's tree."""
    f = IntFp
    lanes = []
    for p, row, live in zip(pts, bits, mask):
        nz = np.flatnonzero(row) if live else []
        acc = INF
        if len(nz):
            acc = p
            for b in row[nz[0] + 1:]:
                acc = dbl_pass(f, acc)
                if b:
                    acc = add_pass(f, acc, p)
        lanes.append(acc)
    m = len(lanes)
    while m > 1:
        m //= 2
        lanes = [add_pass(f, lanes[i], lanes[i + m]) for i in range(m)]
    return lanes[0]


# --- inputs and comparison -----------------------------------------------------


def _same(got, want):
    """A replayed point against JAX's (X, Y, Z) limbs: the Z = 0 flag,
    and the coordinates where Z != 0."""
    w = tuple(_ints(F.fq_canon(torch.from_numpy(np.array(c))).numpy())[0]
              for c in want)
    assert (got[2] % Q == 0) == (w[2] == 0)
    if w[2]:
        assert tuple(c % Q for c in got) == w


def _limbs_and_ints(points):
    x, y = BC.g1_affine_to_limbs(points)
    return x, y, [(F.from_mont(a), F.from_mont(b), 1) for a, b in zip(x, y)]


def _edge_case(B, c, seed):
    """Seeded points where 1 repeats 0, 2 is its negative, 4 the negative
    of 3; digits with window 0 all zero, every point in the top bucket of
    window 1, points 0-2 alone in bucket 3 of window 2, points 3-5 in
    bucket 5 of window 3, the last two points all zero."""
    r = random.Random(seed)
    nb, W = 1 << c, -(-255 // c)
    pts = [Cv.g1.mul(Cv.G1_GEN, r.randrange(1, 2**64)) for _ in range(B)]
    pts[1], pts[2], pts[4] = pts[0], Cv.g1.neg(pts[0]), Cv.g1.neg(pts[3])
    digits = np.array([[r.randrange(nb) for _ in range(W)]
                       for _ in range(B)], np.int32)
    digits[:, 0] = 0
    digits[:, 1] = nb - 1
    digits[3:, 2][digits[3:, 2] == 3] = 2
    digits[:3, 2] = 3
    digits[:3, 3][digits[:3, 3] == 5] = 6
    digits[3:6, 3] = 5
    digits[-2:] = 0
    return pts, digits


def _pairs_case(B, c):
    """Pairs P, -P with equal digits: the sum is infinity."""
    pts = [Cv.g1.mul(Cv.G1_GEN, 7 + i // 2) for i in range(B)]
    pts = [Cv.g1.neg(p) if i % 2 else p for i, p in enumerate(pts)]
    ks = [3 ** (i + 40) % Cv.R for i in range(B // 2)]
    return pts, np.repeat(BC.scalars_to_digits(ks, 255, c), 2, 0)


# --- (a) K13 ---------------------------------------------------------------------


@pytest.mark.parametrize("B,c,case", [(8, 4, "edges"), (8, 4, "pairs"),
                                      (16, 6, "edges"), (16, 8, "edges")])
def test_pippenger_schedule_equals_jax(B, c, case):
    pts, digits = (_edge_case(B, c, seed=B + c) if case == "edges"
                   else _pairs_case(B, c))
    x, y, ints = _limbs_and_ints(pts)
    got = pippenger(ints, digits, c)
    want = JB._msm_pippenger_kernel(B, c)(x, y, digits)
    _same(got, want)
    assert (got[2] == 0) == (case == "pairs")


# --- (b) K14 ---------------------------------------------------------------------


def test_double_add_schedule_equals_jax():
    B, h = 16, 8
    r = random.Random(14)
    pts = [Cv.g1.mul(Cv.G1_GEN, r.randrange(1, 2**64)) for _ in range(B)]
    ks = [r.randrange(Cv.R) for _ in range(B)]
    ks[:6] = [3, 5, 1, Cv.R - 1, 2**254, 0]
    pts[2 + h], ks[2 + h] = pts[2], 1         # P + P at the first level
    pts[3 + h], ks[3 + h] = pts[3], 1         # (r - 1) P + P: infinity
    x, y, ints = _limbs_and_ints(pts)
    x[:2], y[:2] = F.to_mont(0), F.to_mont(2)
    ints[:2] = [(0, 2, 1)] * 2
    bits = BC.scalars_to_bits(ks, 255)
    mask = np.ones(B, bool)
    mask[[h, B - 1]] = False
    got = double_add(ints, bits, mask)
    want = JB._msm_kernel(B)(x, y, bits, mask)
    _same(got, want)
    # the order-3 lanes: 3 (0, 2) is infinity, 5 (0, 2) = -(0, 2)
    assert double_add(ints[:2], bits[:2], [True, False])[2] == 0
    lane = double_add(ints[1:3], bits[1:3], [True, False])
    assert (lane[0] * pow(lane[2], -2, Q) % Q,
            lane[1] * pow(lane[2], -3, Q) % Q) == (0, Q - 2)
