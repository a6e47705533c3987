"""The port's sharded BLS paths (`ops.bls_batch.batch_verify_sharded`:
the plain K8, K25, K26 and K10 on virtual CPU meshes;
`g1_multi_exp_sharded`: the plain K13 per shard and K27) against the JAX
package's `batch_verify_sharded` and `g1_multi_exp_sharded` on the
conftest's 8 virtual CPU devices, one seeded `random.Random` on each
side.  Tolerance zero: verdicts, points and field elements equal (Fq12
values compared at canonical limbs).

- 4 statements at D = 2 (one statement per key, 32-byte messages): the
  padded lanes are 2 x 8, so shard 1 holds padding only; accepted as
  JAX accepts them, and the combined f equal to the plain unsharded
  batch's K9 f under the same scalars (the product of the Miller values
  does not depend on the grouping); the empty shard's partials are the
  identities (an infinite G2 sum, an Fq12 of one);
- one statement signed by a wrong key: rejected as JAX rejects it;
- the MSM at 16 points at D = 1, 2 and 4 against JAX's and the oracle's
  `g1.msm`, with equal partials (a point set repeated in two shards,
  `pt_add`'s doubling branch in the fold) and an empty shard;
- only an implicit request for one card degrades to the single-card
  path, on the caller's `device`; an explicit device list never does.

`slow`: the batch at D = 1 and D = 4, and 9 statements at D = 2 (both
shards live), against JAX (a JAX compile of about 70 s each)."""

import functools
import random

import pytest
import torch

from consensus_specs_tpu.ops import bls_batch as JB
from consensus_specs_tpu.ops.bls import ciphersuite as Jcs
from consensus_specs_tpu_torch.ops import bls_batch as TB
from consensus_specs_tpu_torch.ops.bls import ciphersuite as Tcs
from consensus_specs_tpu_torch.ops.bls import curve as Tcurve
from consensus_specs_tpu_torch.ops.bls_batch import fq as F
from consensus_specs_tpu_torch.ops.bls_batch import tower as tw
from consensus_specs_tpu_torch.parallel import partition as TP

SEED = 5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@functools.cache
def _tasks(n: int, forge=None):
    """(JAX tasks, port tasks) of n statements from the same wire bytes;
    statement `forge` is signed by a wrong key."""
    raw = []
    for t in range(n):
        sk = 3000 + t
        msg = (3000 + t).to_bytes(32, "little")
        raw.append(([Jcs.SkToPk(sk)], msg, Jcs.Sign(sk + (t == forge), msg)))
    return ([Jcs.parse_fast_aggregate_task(*r) for r in raw],
            [Tcs.parse_fast_aggregate_task(*r) for r in raw])


@functools.cache
def _jax_verdict(n: int, d: int, forge=None) -> bool:
    return JB.batch_verify_sharded(_tasks(n, forge)[0],
                                   device_ids=tuple(range(d)),
                                   rng=random.Random(SEED))


def _port(n: int, d: int, forge=None, trace=None) -> bool:
    return TB.batch_verify_sharded(_tasks(n, forge)[1], devices=["cpu"] * d,
                                   rng=random.Random(SEED), trace=trace)


@pytest.fixture(scope="module")
def accepted():
    trace = {}
    ok = _port(4, 2, trace=trace)
    single = {}
    assert TB.batch_verify(_tasks(4)[1], rng=random.Random(SEED),
                           device="cpu", device_h2c=False, trace=single)
    return ok, trace, single


def test_sharded_batch_accepts_as_jax(accepted):
    ok, trace, single = accepted
    assert ok is True and _jax_verdict(4, 2) is True
    assert bool(trace["ok"][0])
    assert torch.equal(F.fq_canon(trace["miller"]),
                       F.fq_canon(single["miller"]))
    assert torch.equal(F.fq_canon(trace["final_exp"]),
                       F.fq_canon(single["final_exp"]))


def test_empty_shard_partials_are_the_identities(accepted):
    _, trace, _ = accepted
    sums, fs = trace["partial_sums"], trace["partial_f"]
    assert sums[0].shape == (2, 2, 33) and fs.shape == (2, 2, 3, 2, 33)
    assert bool(tw.fq2_is_zero(sums[2][1]))              # Z = 0: infinity
    assert not bool(tw.fq2_is_zero(sums[2][0]))
    one = F.fq_canon(F.const(tw.FQ12_ONE_L, "cpu"))
    assert torch.equal(F.fq_canon(fs[1]), one)
    assert not torch.equal(F.fq_canon(fs[0]), one)


def test_sharded_batch_rejects_as_jax():
    assert _jax_verdict(4, 2, forge=2) is False
    assert _port(4, 2, forge=2) is False


@pytest.mark.slow
@pytest.mark.parametrize("n, d", [(4, 1), (4, 4), (9, 2)])
def test_sharded_batch_matches_jax_at_other_widths(n, d):
    trace = {}
    assert _port(n, d, trace=trace) is _jax_verdict(n, d) is True
    assert _port(n, d, forge=n - 1) is _jax_verdict(n, d, n - 1) is False


def _points(n, seed=9):
    rng = random.Random(seed)
    pts = [Tcurve.g1.mul(Tcurve.G1_GEN, rng.randrange(1, Tcurve.R))
           for _ in range(n)]
    ks = [rng.randrange(Tcurve.R) for _ in range(n)]
    return pts, ks


def _jax_point(p):
    return tuple(int(c) for c in p)


@functools.cache
def _oracle(n: int):
    pts, ks = _points(n)
    return Tcurve.g1.to_affine(Tcurve.g1.msm(pts, ks))


@pytest.mark.parametrize("d", [1, 2, 4])
def test_sharded_msm_matches_jax_and_the_oracle(d):
    pts, ks = _points(16)
    got = TB.g1_multi_exp_sharded(pts, ks, devices=["cpu"] * d)
    want = JB.g1_multi_exp_sharded([_jax_point(p) for p in pts], ks,
                                   device_ids=tuple(range(d)))
    assert tuple(int(c) for c in got) == _jax_point(want)
    assert Tcurve.g1.to_affine(got) == _oracle(16)


def test_sharded_msm_equal_partials_and_an_empty_shard():
    pts, ks = _points(8, seed=3)
    # the same 8 lanes in both shards: two equal partials, then their sum
    # by the fold's doubling branch
    got = TB.g1_multi_exp_sharded(pts + pts, ks + ks, devices=["cpu"] * 2)
    assert Tcurve.g1.to_affine(got) == Tcurve.g1.to_affine(
        Tcurve.g1.msm(pts, [2 * k % Tcurve.R for k in ks]))
    # 5 live lanes at D = 2: shard 1 is padding with zero digits
    got = TB.g1_multi_exp_sharded(pts[:5], ks[:5], devices=["cpu"] * 2)
    assert Tcurve.g1.to_affine(got) == Tcurve.g1.to_affine(
        Tcurve.g1.msm(pts[:5], ks[:5]))
    assert Tcurve.g1.is_inf(TB.g1_multi_exp_sharded(
        pts[:2], [0, Tcurve.R], devices=["cpu"] * 2))


def test_only_an_implicit_one_card_request_degrades(monkeypatch):
    monkeypatch.setattr(TP, "available_devices", lambda: 1)
    assert TB._mesh_for(None, None, None) is None
    assert TB._mesh_for(4, None, None) is None
    assert TB._mesh_for(None, None, ["cpu"]).size == 1
    assert TB._mesh_for(None, (0,), None).devices == (torch.device("cuda", 0),)
    monkeypatch.setattr(TP, "available_devices", lambda: 4)
    assert TB._mesh_for(2, None, None).size == 2
    assert TB._mesh_for(None, None, None).size == 4
    monkeypatch.setattr(TP, "available_devices", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TB._mesh_for(None, (0, 1), None)


def test_a_degraded_msm_runs_on_the_callers_device(monkeypatch):
    # one card: the implicit request runs g1_multi_exp_device, on `device`
    # (the CPU here, so its plain versions), not on the default card
    monkeypatch.setattr(TP, "available_devices", lambda: 1)
    pts, ks = _points(16)
    got = TB.g1_multi_exp_sharded(pts, ks, n_devices=4, device="cpu")
    assert Tcurve.g1.to_affine(got) == _oracle(16)
