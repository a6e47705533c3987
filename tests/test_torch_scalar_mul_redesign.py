"""The algebra of the redesigned kernels K8 (`rlc_scalar_mul`) and K16
(`fr_barycentric`) against the JAX package, on the CPU, tolerance zero
(exact finite-field arithmetic; limbs compared after canonicalization).

- (a) The group point passes (`csrc/bls_point_passes.cuh`), their rounds
  replayed on the port's plain tower in the kernel's order (each round's
  operands picked before its products; a G2 product whole, as the Miller
  passes run it, or as its three Karatsuba Fp products, as K8's nine
  ranks run it; products and points canonical), give the
  X3, Y3, Z3 of JAX's `curve_jax.pt_double` and of `pt_add` with Z2 = 1,
  on G1 and G2, with T at infinity, T = Q (the doubling branch) and
  T = -Q (infinity).
- (b) K8's whole chain replayed with those passes (a doubling per bit of
  r, MSB first, an addition per set bit, pad lanes' signatures at
  infinity) and the G1 lane's affine form through the binary inversion
  equals JAX's `pt_scalar_mul` and `g1_to_affine_dev` for the scalars 0,
  1, 2, 3, 2^128 - 1 and seeded ones, with pad lanes (and, on G1, 3 and
  5 on the point (0, 2) of order 3).
- (c) The binary inversion (`mont_inv_binary` in `csrc/mont.cuh`),
  replayed word by word in Python ints at 8 and 12 words, equals
  pow(a, m - 2, m) at 0, 1, m - 1, R mod m and seeded values, and after
  its two products by R^2 the limbs of JAX's `FR.inv` and `fq_inv`.
- (d) K16's formula with that inversion equals JAX's
  `_barycentric_kernel` at W = 16, z on the domain and a coset included.

The kernels themselves are held against the plain versions on the card
(`tests/test_torch_cuda.py`, `chip_smoke.py`)."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consensus_specs_tpu.ops import bls_batch as JB
from consensus_specs_tpu.ops import fr_batch as JR
from consensus_specs_tpu.ops.bls import curve as jax_curve
from consensus_specs_tpu.ops.bls_batch import curve_jax as Jc
from consensus_specs_tpu.ops.bls_batch import fq as Jf
from consensus_specs_tpu.ops.bls_batch import tower as Jt
from consensus_specs_tpu_torch.ops import fr_batch as FB
from consensus_specs_tpu_torch.ops.bls.fields import Q
from consensus_specs_tpu_torch.ops.bls_batch import curve as C
from consensus_specs_tpu_torch.ops.bls_batch import fq as F

R_FR = FB.R_MODULUS
MASK32 = 0xFFFFFFFF


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
    if name not in _JIT:
        _JIT[name] = jax.jit(fn)
    return jax.tree_util.tree_map(np.asarray, _JIT[name](*args))


def _t(a):
    return torch.from_numpy(np.array(a))


def _same_canon(got, want):
    for g, w in zip(got, want):
        g, w = F.fq_canon(_t(np.asarray(g))), F.fq_canon(_t(np.asarray(w)))
        assert g.shape == w.shape and torch.equal(g, w)


# --- the replay of the group point passes ------------------------------------


class _Field:
    """The kernels' field on the port's plain tower: G1's Fp, or G2's
    Fp2 with each product whole (`split` False, the Miller passes) or as
    its three Karatsuba Fp products a0 b0, a1 b1, (a0 + a1)(b0 + b1)
    (K8's nine ranks).  Sums stay lazy between products; the products
    and the passes' points are canonical."""

    def __init__(self, g2: bool, split: bool = False):
        self.ops = C.F2 if g2 else C.F1
        self.g2, self.split = g2, split

    def add(self, a, b):
        return self.ops.add(a, b)

    def sub(self, a, b):
        return self.ops.sub(a, b)

    def dbl(self, a):
        return self.add(a, a)

    def triple(self, a):
        return self.add(self.dbl(a), a)

    def mul_round(self, pairs):
        """A round's independent products, in one stacked call."""
        a = torch.stack([x for x, _ in pairs])
        b = torch.stack([y for _, y in pairs])
        if not (self.g2 and self.split):
            return F.fq_canon(self.ops.mul(a, b)).unbind(0)
        a0, a1, b0, b1 = a[..., 0, :], a[..., 1, :], b[..., 0, :], b[..., 1, :]
        p = F.fq_canon(F.fq_mul(torch.stack([a0, a1, F.fq_add(a0, a1)]),
                                torch.stack([b0, b1, F.fq_add(b0, b1)])))
        c0 = F.fq_sub(p[0], p[1])
        c1 = F.fq_sub(p[2], F.fq_add(p[0], p[1]))
        return F.fq_canon(torch.stack([c0, c1], dim=-2)).unbind(0)


DBL_PRODUCTS = (3, 3, 1)
ADD_PRODUCTS = (1, 2, 3, 2, 2, 1)


def _dbl_operands(f, P, t, k, j):
    """Product j of doubling round k: (a, b, slot), `pt_dbl_operands`."""
    X, Y, Z = P["X"], P["Y"], P["Z"]
    if k == 0:
        return (X, Y, Y)[j], (X, Y, Z)[j], ("XX", "YY", "YZ")[j]
    if k == 1:
        if j == 0:
            return t["YY"], t["YY"], "C"
        if j == 1:
            return X, t["YY"], "XYY"
        e = f.triple(t["XX"])
        return e, e, "F"
    u = f.dbl(f.dbl(t["XYY"]))                  # D = 4 X Y^2
    v = f.sub(t["F"], f.dbl(u))                 # X3 = F - 2D
    return f.triple(t["XX"]), f.sub(u, v), "EDX"


def _add_operands(f, P, t, k, j):
    """Product j of addition round k: (a, b, slot), `pt_add_operands`."""
    X, Y, Z, xq, yq = P["X"], P["Y"], P["Z"], P["xq"], P["yq"]
    if k == 0:
        return Z, Z, "ZZ"
    if k == 1:
        return ((t["ZZ"], Z, "ZZZ"), (xq, t["ZZ"], "U2"))[j]
    if k == 2:
        if j == 0:
            return yq, t["ZZZ"], "S2"
        if j == 1:
            return Z, f.sub(X, t["U2"]), "ZH"
        h2 = f.dbl(f.sub(t["U2"], X))
        return h2, h2, "I"
    if k == 3:
        return ((f.sub(t["U2"], X), t["I"], "J"), (X, t["I"], "V"))[j]
    if k == 4:
        if j == 0:
            rr = f.dbl(f.sub(t["S2"], Y))
            return rr, rr, "RR"
        return Y, t["J"], "YJ"
    x3 = f.sub(f.sub(t["RR"], t["J"]), f.dbl(t["V"]))
    return f.dbl(f.sub(t["S2"], Y)), f.sub(t["V"], x3), "Y3"


def _rounds(f, P, operands, counts):
    """The pass's rounds: every operand of a round picked from the state
    before its products (the kernels' barriers), then the products."""
    t = {}
    for k, n in enumerate(counts):
        picked = [operands(f, P, t, k, j) for j in range(n)]
        for (_, _, slot), v in zip(picked, f.mul_round(
                [(a, b) for a, b, _ in picked])):
            t[slot] = v
    return t


def _select(mask, p, q):
    return tuple(torch.where(mask[(...,) + (None,) * (a.dim() - 1)], a, b)
                 for a, b in zip(p, q))


def dbl_pass(f, P):
    """T <- 2T: the rounds, then `pt_dbl_finish`."""
    t = _rounds(f, P, _dbl_operands, DBL_PRODUCTS)
    u = f.dbl(f.dbl(f.dbl(t["XYY"])))
    c8 = f.dbl(f.dbl(f.dbl(t["C"])))
    return dict(P, X=F.fq_canon(f.sub(t["F"], u)),
                Y=F.fq_canon(f.sub(t["EDX"], c8)), Z=F.fq_canon(f.dbl(t["YZ"])))


def add_pass(f, P):
    """T <- T + Q: the rounds, then `pt_add_finish`'s cases in its order
    (T at infinity gives Q; H = 0 doubles T where S2 = Y, else gives
    infinity)."""
    t = _rounds(f, P, _add_operands, ADD_PRODUCTS)
    X, Y, Z = P["X"], P["Y"], P["Z"]
    x3 = f.sub(f.sub(t["RR"], t["J"]), f.dbl(t["V"]))
    zero = torch.zeros_like(Z)
    out = tuple(map(F.fq_canon, (x3, f.sub(t["Y3"], f.dbl(t["YJ"])),
                                 f.sub(zero, f.dbl(t["ZH"])))))
    h0 = f.ops.is_zero(f.sub(t["U2"], X))
    u0 = f.ops.is_zero(f.sub(t["S2"], Y))
    inf = tuple(map(F.fq_canon, C.pt_infinity(f.ops, (X, Y, Z))))
    if bool((h0 & u0).any()):
        doubled = tuple(map(F.fq_canon, C.pt_double(f.ops, (X, Y, Z))))
        out = _select(h0 & u0, doubled, out)
    out = _select(h0 & ~u0, inf, out)
    one = inf[0]
    out = _select(f.ops.is_zero(Z), (P["xq"], P["yq"], one), out)
    return dict(P, X=out[0], Y=out[1], Z=out[2])


# --- inputs ------------------------------------------------------------------

FIELDS = {"g1": (False, Jc.F1, jax_curve.g1, jax_curve.G1_GEN),
          "g2": (True, Jc.F2, jax_curve.g2, jax_curve.G2_GEN)}


def _coord(g2, v):
    return Jt.fq2_from_oracle(v) if g2 else Jf.to_mont(v)


def _jac(name, pts, lam):
    """Oracle points as (X, Y, Z) limb stacks at the Jacobian
    representative (X l^2, Y l^3, Z l)."""
    g2, _, group, _ = FIELDS[name]
    lam = jax_curve.Fq2(lam, 3) if g2 else lam
    m = group.fmul
    out = [(m(x, m(lam, lam)), m(y, m(lam, m(lam, lam))), m(z, lam))
           for x, y, z in pts]
    return tuple(np.stack([_coord(g2, p[i]) for p in out]) for i in range(3))


def _affine(name, pts):
    g2, _, group, _ = FIELDS[name]
    aff = [group.to_affine(p) for p in pts]
    return tuple(np.stack([_coord(g2, a[i]) for a in aff]) for i in range(2))


def _infinite(name, n):
    one = np.broadcast_to(FIELDS[name][1].one,
                          (n,) + FIELDS[name][1].one.shape).copy()
    return one, one.copy(), np.zeros_like(one)


CASES = ("generic", "generic", "T_inf", "T_eq_Q", "T_neg_Q")


def _pass_inputs(name):
    """Lanes of T (Jacobian) and Q (affine) for CASES."""
    g2, _, group, gen = FIELDS[name]
    r = random.Random(17 + g2)
    qs = [group.mul(gen, r.randrange(1, 2**64)) for _ in CASES]
    ts = [group.mul(gen, r.randrange(1, 2**64)) for _ in CASES]
    ts[3], ts[4] = qs[3], group.neg(qs[4])
    T = [np.array(c) for c in _jac(name, ts, 7)]
    inf = _infinite(name, 1)
    for c in range(3):
        T[c][2] = inf[c][0]
    return tuple(T), _affine(name, qs)


@pytest.mark.parametrize("name,split", [("g1", False), ("g2", False),
                                        ("g2", True)])
def test_point_passes_equal_jax_double_and_add(name, split):
    g2, F_j = FIELDS[name][:2]
    T, (xq, yq) = _pass_inputs(name)
    f = _Field(g2, split)
    P = {"X": F.fq_canon(_t(T[0])), "Y": F.fq_canon(_t(T[1])),
         "Z": F.fq_canon(_t(T[2])), "xq": _t(xq), "yq": _t(yq)}
    got = dbl_pass(f, P)
    want = _jax(f"dbl{name}", lambda a: Jc.pt_double(F_j, a), T)
    _same_canon((got["X"], got["Y"], got["Z"]), want)
    one = np.broadcast_to(F_j.one, xq.shape).copy()
    got = add_pass(f, P)
    want = _jax(f"add{name}", lambda a, b: Jc.pt_add(F_j, a, b), T,
                (xq, yq, one))
    _same_canon((got["X"], got["Y"], got["Z"]), want)
    z = F.fq_canon(got["Z"]).reshape(len(CASES), -1).any(dim=1)
    assert z.tolist() == [True, True, True, True, False]


# --- K8's chain ----------------------------------------------------------------

SCALARS = (0, 1, 2, 3, 2**128 - 1)


def _chain_inputs(name):
    """Points and scalars of K8's edge lanes: SCALARS, seeded ones, and on
    G1 the point (0, 2) of order 3 with 3 and 5; lanes 2 and 8 padding."""
    g2, _, group, gen = FIELDS[name]
    r = random.Random(5 + g2)
    scalars = list(SCALARS) + [r.getrandbits(128) for _ in range(2)]
    scalars += [3, 5]
    pts = [group.mul(gen, r.randrange(1, 2**64)) for _ in scalars]
    xq, yq = _affine(name, pts)
    if not g2:
        xq[-2:], yq[-2:] = Jf.to_mont(0), Jf.to_mont(2)
    mask = np.ones(len(scalars), bool)
    mask[[2, 8]] = False
    return xq, yq, C.scalars_to_bits(scalars, 128), mask


def _chain(f, xq, yq, bits):
    inf = tuple(map(F.fq_canon, C.pt_infinity(f.ops, (_t(xq),) * 3)))
    P = {"X": inf[0], "Y": inf[1], "Z": inf[2], "xq": _t(xq), "yq": _t(yq)}
    for i in range(bits.shape[1]):
        P = dbl_pass(f, P)
        add = add_pass(f, P)
        sel = _select(torch.from_numpy(bits[:, i] != 0),
                      (add["X"], add["Y"], add["Z"]), (P["X"], P["Y"], P["Z"]))
        P = dict(P, X=sel[0], Y=sel[1], Z=sel[2])
    return P


def _to_int(limbs) -> int:
    return Jf.from_mont(np.asarray(limbs))


def test_k8_chain_equals_jax_scalar_mul_g1_affine():
    xq, yq, bits, mask = _chain_inputs("g1")
    P = _chain(_Field(False), xq, yq, bits)
    ax, ay, inf = [], [], []
    for X, Y, Z in zip(P["X"], P["Y"], P["Z"]):
        z = _to_int(Z)
        zi = _from_kernel(_inv_binary(_to_kernel(z, Q, 12), Q, 12), Q, 12)
        ax.append(Jf.to_mont(_to_int(X) * zi * zi % Q))
        ay.append(Jf.to_mont(_to_int(Y) * zi * zi * zi % Q))
        inf.append(z == 0)
    one = np.broadcast_to(Jf.ONE_MONT, xq.shape).copy()
    p = _jax("smul_g1", lambda a, b: Jc.pt_scalar_mul(Jc.F1, a, b),
             (xq, yq, one), bits)
    wx, wy, winf = _jax("aff_g1", JB.g1_to_affine_dev, p)
    _same_canon((np.stack(ax), np.stack(ay)), (wx, wy))
    assert inf == winf.tolist()
    assert inf == [True, False, False, False, False, False, False, True,
                   False]


def test_k8_chain_equals_jax_scalar_mul_g2_masked():
    xq, yq, bits, mask = _chain_inputs("g2")
    P = _chain(_Field(True, split=True), xq, yq, bits)
    inf = tuple(map(F.fq_canon, C.pt_infinity(C.F2, (P["X"],) * 3)))
    got = _select(~torch.from_numpy(mask), inf, (P["X"], P["Y"], P["Z"]))
    one = np.broadcast_to(Jt.FQ2_ONE_L, xq.shape).copy()

    def ref(a, b, m):
        s = Jc.pt_scalar_mul(Jc.F2, a, b)
        return Jc.pt_select(Jc.F2, m, s, Jc.pt_infinity(Jc.F2, s))

    _same_canon(got, _jax("smul_g2", ref, (xq, yq, one), bits, mask))


# --- the binary inversion, word by word ----------------------------------------


def _words(x: int, nw: int) -> list[int]:
    return [(x >> (32 * j)) & MASK32 for j in range(nw)]


def _int(w) -> int:
    return sum(v << (32 * j) for j, v in enumerate(w))


def _sub_mod(a, b, m, nw):
    """`mont_sub` over words: a - b, plus m on a borrow."""
    t, borrow = [], 0
    for j in range(nw):
        s = a[j] - b[j] - borrow
        t.append(s & MASK32)
        borrow = 1 if s < 0 else 0
    mask = MASK32 if borrow else 0
    out, c = [], 0
    for j in range(nw):
        s = t[j] + (m[j] & mask) + c
        out.append(s & MASK32)
        c = s >> 32
    return out


def _inv_binary(a: int, mod: int, nw: int) -> int:
    """`mont_inv_binary`'s loop on NW 32-bit words, step for step: the
    integer inverse of a mod m (0 -> 0), before the two products by R^2."""
    m = _words(mod, nw)
    u, v, x1, x2 = _words(a, nw), list(m), [1] + [0] * (nw - 1), [0] * nw
    for _ in range(64 * nw):
        odd = MASK32 if u[0] & 1 else 0
        d, borrow = [], 0
        for j in range(nw):
            s = u[j] - v[j] - borrow
            d.append(s & MASK32)
            borrow = 1 if s < 0 else 0
        lt = MASK32 if borrow else 0
        swap = odd & lt
        e, f = _sub_mod(x1, x2, m, nw), _sub_mod(x2, x1, m, nw)
        c = 1
        for j in range(nw):
            nd = ((~d[j] & MASK32) + c) & MASK32
            c = c & (nd == 0)
            diff = (nd & lt) | (d[j] & ~lt & MASK32)
            dx = (f[j] & lt) | (e[j] & ~lt & MASK32)
            v[j] = (u[j] & swap) | (v[j] & ~swap & MASK32)
            x2[j] = (x1[j] & swap) | (x2[j] & ~swap & MASK32)
            u[j] = (diff & odd) | (u[j] & ~odd & MASK32)
            x1[j] = (dx & odd) | (x1[j] & ~odd & MASK32)
        x_odd = MASK32 if x1[0] & 1 else 0
        cy = 0
        for j in range(nw):
            s = x1[j] + (m[j] & x_odd) + cy
            x1[j] = s & MASK32
            cy = s >> 32
        assert cy == 0
        for j in range(nw - 1):
            u[j] = (u[j] >> 1) | ((u[j + 1] << 31) & MASK32)
            x1[j] = (x1[j] >> 1) | ((x1[j + 1] << 31) & MASK32)
        u[nw - 1] >>= 1
        x1[nw - 1] >>= 1
    assert _int(u) == 0 and _int(v) == (1 if a else mod)
    return _int(x2)


def _mont(a: int, b: int, mod: int, nw: int) -> int:
    return a * b * pow(2, -32 * nw, mod) % mod


def _to_kernel(x: int, mod: int, nw: int) -> int:
    """x -> the kernels' Montgomery value x R, R = 2^(32 NW)."""
    return x * pow(2, 32 * nw, mod) % mod


def _from_kernel(a: int, mod: int, nw: int) -> int:
    """The kernels' value x R after the inverse's two products by R^2 ->
    x: mont_inv_binary's output for input x R is x^-1 R."""
    r2 = pow(2, 64 * nw, mod)
    out = _mont(_mont(a, r2, mod, nw), r2, mod, nw)
    return out * pow(2, -32 * nw, mod) % mod


@pytest.mark.parametrize("field", ["fr", "fp"])
def test_binary_inversion_word_by_word(field):
    mod, nw = (R_FR, 8) if field == "fr" else (Q, 12)
    r = random.Random(nw)
    xs = [0, 1, mod - 1, pow(2, 32 * nw, mod), pow(2, 396, mod)]
    xs += [r.randrange(mod) for _ in range(6)]
    got = []
    for x in xs:
        a = _to_kernel(x, mod, nw)
        inv = _inv_binary(a, mod, nw)
        assert inv == pow(a, mod - 2, mod)
        got.append(_from_kernel(inv, mod, nw))
    if field == "fr":
        lim = np.stack([JR.FR.to_mont(x) for x in xs])
        want = FB.FR.canon(_t(_jax("fr_inv", JR.FR.inv, lim)))
        mine = torch.from_numpy(np.stack([JR.FR.to_mont(x) for x in got]))
    else:
        lim = np.stack([Jf.to_mont(x) for x in xs])
        want = F.fq_canon(_t(_jax("fq_inv", Jf.fq_inv, lim)))
        mine = torch.from_numpy(np.stack([Jf.to_mont(x) for x in got]))
    assert torch.equal(mine, want)
    assert got[0] == 0 and got[1] == 1


# --- K16's formula ---------------------------------------------------------------


@pytest.mark.parametrize("case", ["random_z", "z_on_domain", "coset"])
def test_barycentric_with_binary_inversion_equals_jax(case):
    W, r = 16, random.Random(case)
    g = pow(7, (R_FR - 1) // W, R_FR)
    shift = 5 if case == "coset" else 1
    domain = [shift * pow(g, i, R_FR) % R_FR for i in range(W)]
    poly = [r.randrange(R_FR) for _ in domain]
    z = domain[3] if case == "z_on_domain" else r.randrange(R_FR)
    acc = 0
    for f_i, x in zip(poly, domain):                # the terms launch
        d = _to_kernel((z - x) % R_FR, R_FR, 8)
        inv = _from_kernel(_inv_binary(d, R_FR, 8), R_FR, 8)
        acc = (acc + f_i * x * inv) % R_FR
    hw = pow(shift, W, R_FR)                         # the finish launch
    y = acc * (pow(z, W, R_FR) - hw) * pow(W * hw, R_FR - 2, R_FR) % R_FR
    arrays = FB.barycentric_inputs(poly, domain, z, shift)
    want = JR._barycentric_kernel(W)(*(jnp.asarray(a) for a in arrays))
    assert torch.equal(torch.from_numpy(JR.FR.to_mont(y)),
                       FB.FR.canon(_t(np.asarray(want))))
    assert (y == 0) == (case == "z_on_domain")
