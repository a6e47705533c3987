"""Slices 3 and 4 of the port as a whole: the RLC batch verify (host and
device hashing) and the BLS facade, against
`consensus_specs_tpu.ops.bls_batch` and `consensus_specs_tpu.ops.bls`,
tolerance zero.

- the port's host oracle copies agree with the JAX package's on parsing,
  hash-to-G2, signing and FastAggregateVerify;
- `convert.rlc_inputs` equals JAX's `_prepare_rlc_inputs` array by
  array (host hashing, and the message words of device hashing), with
  one seeded `random.Random` on each side;
- the whole slice at bucket 8 (2 live statements): the port's plain
  `batch_verify(device="cpu", device_h2c=False)` gives JAX's
  `batch_verify(..., device_h2c=False)` verdict (its intermediates are
  held against JAX's components in `tests/test_torch_bls_slice.py`);
- `batch_verify` hashes on the device by default for 32-byte messages;
- the facade: backends, the kill-switch, `DeferredBatch` recording,
  once-only settlement and handles.

The rejected batch, one-sided infinity, the device-hashed batch against
JAX's (accept and reject) and a `DeferredBatch` settled through the
plain batch are `slow` here; `chip_smoke.py` and
`tests/test_torch_cuda.py` hold them on the card."""

import random

import numpy as np
import pytest
import torch

from consensus_specs_tpu.ops import bls_batch as JB
from consensus_specs_tpu.ops.bls import ciphersuite as Jcs
from consensus_specs_tpu.ops.bls import curve as Jcurve
from consensus_specs_tpu.ops.bls import hash_to_curve as Jh2c
from consensus_specs_tpu.ops.bls_batch import h2c_jax as Jh2cdev
from consensus_specs_tpu_torch import convert as C
from consensus_specs_tpu_torch.ops import bls as TBLS
from consensus_specs_tpu_torch.ops import bls_batch as TB
from consensus_specs_tpu_torch.ops.bls import ciphersuite as Tcs
from consensus_specs_tpu_torch.ops.bls import curve as Tcurve
from consensus_specs_tpu_torch.ops.bls import hash_to_curve as Th2c

SEED = 5


def _raw(n, keys=2, base=1000, forge=None):
    """n FastAggregateVerify statements as wire bytes: `keys` public keys
    each, their aggregate signature over a 32-byte message; statement
    `forge` is signed by a wrong key."""
    out = []
    for t in range(n):
        sks = [base + t * keys + i for i in range(keys)]
        msg = (base + t).to_bytes(32, "little")
        sigs = [Jcs.Sign(sk + (t == forge), msg) for sk in sks]
        out.append(([Jcs.SkToPk(sk) for sk in sks], msg,
                    Jcs.Aggregate(sigs)))
    return out


def _tasks(raw):
    """(JAX tasks, port tasks): each package parses the same bytes."""
    return ([Jcs.parse_fast_aggregate_task(*r) for r in raw],
            [Tcs.parse_fast_aggregate_task(*r) for r in raw])


def _same(got, want):
    if isinstance(got, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
        return
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)


# --- the host oracle copies ------------------------------------------------------


def test_oracle_copies_agree_on_keys_signatures_and_parsing():
    for sk in (1, 7, 2**200 + 3):
        assert Tcs.SkToPk(sk) == Jcs.SkToPk(sk)
    msg = b"\x42" * 32
    sig = Tcs.Sign(12345, msg)
    assert sig == Jcs.Sign(12345, msg)
    assert Tcs.Aggregate([sig, Tcs.Sign(7, msg)]) == Jcs.Aggregate(
        [sig, Jcs.Sign(7, msg)])
    assert (Tcurve.H1, Tcurve.H2) == (Jcurve.H1, Jcurve.H2)
    assert Th2c.DST_G2 == Jh2c.DST_G2
    pk = Tcs.SkToPk(99)
    for data in (pk, Tcs.G1_POINT_AT_INFINITY, b"\x80" + b"\x00" * 47,
                 b"\x00" * 48, pk[:47]):
        for mine, ref in ((Tcs.KeyValidate, Jcs.KeyValidate),):
            assert mine(data) == ref(data)
    for data in (sig, Tcs.G2_POINT_AT_INFINITY, b"\xa0" + b"\x01" * 95):
        try:
            want = Jcurve.g2_to_bytes(Jcurve.g2_from_bytes(data))
        except ValueError:
            with pytest.raises(ValueError):
                Tcurve.g2_from_bytes(data)
        else:
            assert Tcurve.g2_to_bytes(Tcurve.g2_from_bytes(data)) == want


@pytest.mark.parametrize("msg", [b"", b"\x00" * 32, b"abc" * 50])
def test_oracle_hash_to_g2_agrees(msg):
    mine = Tcurve.g2_to_bytes(Th2c.hash_to_g2(msg, Th2c.DST_G2))
    assert mine == Jcurve.g2_to_bytes(Jh2c.hash_to_g2(msg, Jh2c.DST_G2))


def test_oracle_fast_aggregate_verify_agrees():
    (pks, msg, sig), = _raw(1, keys=3)
    for args in ((pks, msg, sig), (pks, b"\x01" * 32, sig),
                 (pks[:2], msg, sig), ([], msg, sig)):
        assert Tcs.FastAggregateVerify(*args) == \
            Jcs.FastAggregateVerify(*args)
    assert Tcs.FastAggregateVerify(pks, msg, sig) is True


def test_parse_fast_aggregate_task_agrees():
    raw = _raw(2)
    jt, tt = _tasks(raw)
    for j, t in zip(jt, tt):
        assert Tcurve.g1_to_bytes(t[0]) == Jcurve.g1_to_bytes(j[0])
        assert t[1] == j[1]
        assert Tcurve.g2_to_bytes(t[2]) == Jcurve.g2_to_bytes(j[2])
    bad = (raw[0][0], raw[0][1], b"\x01" * 96)
    assert Tcs.parse_fast_aggregate_task(*bad) is None
    assert Jcs.parse_fast_aggregate_task(*bad) is None


# --- host prep ---------------------------------------------------------------------


def test_bucket_matches_jax():
    for n in list(range(0, 140)) + [511, 512, 513, 1000, 5000]:
        assert TB._bucket(n) == JB._bucket(n), n


@pytest.mark.parametrize("n", [3, 9])
def test_rlc_inputs_match_jax_prepare(n):
    """Buckets 8 and 16: the port pads to `_bucket(n)`, as JAX does when
    it is given no lane count."""
    jt, tt = _tasks(_raw(n))
    want, n_j = JB._prepare_rlc_inputs(jt, random.Random(SEED), None)
    got, n_t = C.rlc_inputs(tt, random.Random(SEED), "cpu")
    assert n_t == n_j == n
    assert got[0].shape[0] == TB._bucket(n) == JB._bucket(n)
    names = ("pk_x", "pk_y", "sig_x", "sig_y", "h_x", "h_y", "r_bits",
             "mask")
    for name, g, w in zip(names, got, want):
        assert g.device.type == "cpu", name
        _same(g, w)
    r_bits = got[6].numpy()
    assert r_bits[0, -1] == 1 and not r_bits[0, :-1].any()     # r_0 = 1
    assert (r_bits[1:n, -1] == 1).all()                       # odd draws
    assert not r_bits[n:].any() and not got[7][n:].any()      # pad lanes


def test_rlc_inputs_device_h2c_match_jax_prepare():
    """Device hashing: the message words in place of (h_x, h_y), the
    same bits as JAX's uint32 words, padded by repeating row 0."""
    jt, tt = _tasks(_raw(3))
    want, n_j = JB._prepare_rlc_inputs(jt, random.Random(SEED), None,
                                       device_h2c=True)
    got, n_t = C.rlc_inputs(tt, random.Random(SEED), "cpu", device_h2c=True)
    assert n_t == n_j == 3 and len(got) == len(want) == 7
    assert got[4].dtype == torch.int32 and got[4].shape == (8, 8)
    _same(got[4].numpy().view(np.uint32), want[4])
    for i in (0, 1, 2, 3, 5, 6):
        _same(got[i], want[i])


def test_rlc_inputs_degenerate_batches():
    """Nothing to check: True.  Infinity on one side of a statement: no
    batch, each statement checked by `pairing_check_device` (JAX `:622`),
    here on the CPU: the oracle's verdict, False."""
    inf = (Tcurve.g1.infinity(), b"\x00" * 32, Tcurve.g2.infinity())
    assert C.rlc_inputs([inf, inf], random.Random(0), "cpu") == (None, True)
    (pk, msg, sig), = _tasks(_raw(1))[1]
    one_sided = [(pk, msg, Tcurve.g2.infinity()), (pk, msg, sig)]
    assert C.rlc_inputs(one_sided, random.Random(0), "cpu") == (None, False)


# --- the whole slice at bucket 8 ----------------------------------------------------


def test_whole_slice_verdict_equals_jax_batch_verify():
    """Two live statements at bucket 8: the port's plain batch gives JAX's
    verdict (`tests/test_torch_bls_slice.py` holds its intermediates
    against JAX's components)."""
    jt, tt = _tasks(_raw(2))
    want = JB.batch_verify(jt, rng=random.Random(SEED), device_h2c=False)
    assert want is True
    assert TB.batch_verify(tt, rng=random.Random(SEED), device="cpu",
                           device_h2c=False) is want


# --- the entry points' refusals and degenerate batches ------------------------------


def test_batch_verify_hashes_on_the_device_by_default(monkeypatch):
    """32-byte messages go through the device hash stage (K11's route)
    unless `device_h2c=False`; other lengths are hashed on the host, as
    JAX routes them, even with `device_h2c=True`.  The stages are spies here: the verdicts through
    both routes are held in the slow tests below and on the card."""
    calls = []

    def hash_stage(words):
        calls.append(words.shape)
        B = words.shape[0]
        return (torch.zeros((B, 2, 33), dtype=torch.int32),) * 2 + (
            torch.ones(B, dtype=torch.bool),)

    monkeypatch.setattr(TB, "hash_to_g2_affine", hash_stage)
    monkeypatch.setattr(TB, "_rlc_pairing_core",
                        lambda *a, **k: torch.ones(1, dtype=torch.bool))
    _, tt = _tasks(_raw(2))
    trace = {}
    assert TB.batch_verify(tt, rng=random.Random(SEED), device="cpu",
                           trace=trace) is True
    assert calls == [(8, 8)] and len(trace["inputs"]) == 7
    words = trace["inputs"][4].numpy().view(np.uint32)
    _same(words[:2], Jh2cdev.msgs_to_words([t[1] for t in tt]))
    for flag in (False, True):
        tasks = tt if flag is False else [(pk, m + b"\x00", s)
                                          for pk, m, s in tt]
        trace = {}
        TB.batch_verify(tasks, rng=random.Random(SEED), device="cpu",
                        device_h2c=flag, trace=trace)
        assert calls == [(8, 8)] and len(trace["inputs"]) == 8


def test_batch_verify_runs_on_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the card tests cover it")
    (task,) = _tasks(_raw(1))[1]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TB.batch_verify([task])


def test_batch_verify_trivial_batches():
    assert TB.batch_verify([], device="cpu") is True
    inf = (Tcurve.g1.infinity(), b"\x00" * 32, Tcurve.g2.infinity())
    assert TB.batch_verify([inf, inf], device="cpu") is True
    assert JB.batch_verify([(Jcurve.g1.infinity(), b"\x00" * 32,
                             Jcurve.g2.infinity())],
                           device_h2c=False) is True


# --- the facade ----------------------------------------------------------------------


@pytest.fixture
def backend():
    saved = TBLS.backend_name()
    yield TBLS
    TBLS.use_backend(saved)
    TBLS.bls_active = True


def test_facade_backends_and_eager_calls(backend, monkeypatch):
    """Under "torch" the eager calls check on the card (CUDA by default,
    so they raise without one); inputs that fail parsing, and pairs all
    at infinity, decide without a device."""
    (pks, msg, sig), = _raw(1)
    backend.use_backend("py")
    assert backend.FastAggregateVerify(pks, msg, sig) is True
    assert backend.Verify(pks[0], msg, sig) is False
    with pytest.raises(AssertionError):
        backend.use_backend("jax")
    backend.use_backend("torch")
    assert backend.Verify(pks[0], msg, b"\x01" * 96) is False
    assert backend.FastAggregateVerify([], msg, sig) is False
    assert backend.AggregateVerify(pks, [msg], sig) is False
    if not torch.cuda.is_available():
        for call in (lambda: backend.Verify(pks[0], msg, sig),
                     lambda: backend.FastAggregateVerify(pks, msg, sig),
                     lambda: backend.AggregateVerify(pks, [msg, msg], sig)):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call()
    monkeypatch.setattr(backend, "_device", "cpu")
    assert backend.pairing_check([]) is True
    assert backend.pairing_check([(backend.Z1(), backend.G2())]) is True
    assert backend.SkToPk(5) == Jcs.SkToPk(5)
    backend.bls_active = False
    assert backend.Verify(b"", b"", b"") is True
    assert backend.Sign(1, b"") == backend.STUB_SIGNATURE


def test_deferred_batch_settles_on_the_card_by_default(backend):
    """The facade's default backend is the card: with no backend chosen,
    `verify()` asks for CUDA (and raises without a card) rather than
    settling on the host oracle."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the card tests cover it")
    assert backend.backend_name() == "torch"
    (raw,) = _raw(1)
    for device in (None, True):
        batch = backend.DeferredBatch()
        assert batch.record(*raw) is True
        with pytest.raises(RuntimeError, match="no CUDA device"):
            batch.verify(device=device)


def test_deferred_batch_records_and_settles_on_the_host(backend):
    backend.use_backend("py")
    raw = _raw(2)
    with backend.deferred_batch_verification() as batch:
        assert all(backend.FastAggregateVerify(*r) for r in raw)
        with pytest.raises(AssertionError):
            backend.deferred_batch_verification().__enter__()
    assert len(batch.tasks) == 2 and not batch.handles[0].done()
    assert batch.handles[1].result() is True          # settles the batch
    assert batch.verify() is True and batch.handles[0].done()
    with pytest.raises(RuntimeError, match="already settled"):
        batch.record(*raw[0])


def test_deferred_batch_rejects_invalid_input_without_a_batch(backend):
    backend.use_backend("torch")
    raw = _raw(1)
    batch = backend.DeferredBatch()
    assert batch.record(*raw[0]) is True
    assert batch.record(raw[0][0], raw[0][1], b"\x01" * 96) is False
    assert batch.handles[1].result() is False
    # an invalid input decides the batch: no device is asked for
    assert batch.verify() is False and batch.verify() is False
    assert batch.handles[0].result() is False
    assert backend.DeferredBatch().verify() is True


def test_deferred_batch_failure_reaches_every_handle(backend):
    backend.use_backend("torch")
    batch = backend.DeferredBatch()
    for r in _raw(2):
        batch.record(*r)
    with pytest.raises(NotImplementedError):
        batch.verify(device="cpu", rng=_Refusing())
    for h in batch.handles:
        with pytest.raises(NotImplementedError):
            h.result()
    with pytest.raises(NotImplementedError):
        batch.verify()


class _Refusing(random.Random):
    def getrandbits(self, k):
        raise NotImplementedError("no coefficients")


# --- slow: the plain batch on rejected and degenerate inputs -------------------------


@pytest.mark.slow
def test_rejected_batch_matches_jax():
    jt, tt = _tasks(_raw(3, forge=1))
    want = JB.batch_verify(jt, rng=random.Random(SEED), device_h2c=False)
    assert want is False
    assert TB.batch_verify(tt, rng=random.Random(SEED), device="cpu",
                           device_h2c=False) is False


@pytest.mark.slow
@pytest.mark.parametrize("forge", [None, 1])
def test_device_h2c_batch_matches_jax(forge):
    """Bucket 8 with the messages hashed by the plain device route,
    against JAX's `batch_verify(..., device_h2c=True)`."""
    jt, tt = _tasks(_raw(2, forge=forge))
    want = JB.batch_verify(jt, rng=random.Random(SEED), device_h2c=True)
    assert want is (forge is None)
    assert TB.batch_verify(tt, rng=random.Random(SEED), device="cpu",
                           device_h2c=True) is want


@pytest.mark.slow
def test_one_sided_infinity_matches_jax_and_the_oracle():
    jt, tt = _tasks(_raw(2))
    bad_t = list(tt)
    bad_t[1] = (tt[1][0], tt[1][1], Tcurve.g2.infinity())
    bad_j = list(jt)
    bad_j[1] = (jt[1][0], jt[1][1], Jcurve.g2.infinity())
    want = JB.batch_verify(bad_j, rng=random.Random(SEED), device_h2c=False)
    oracle = all(Tcs._pairing_check(Tcs.fast_aggregate_pairs(t))
                 for t in bad_t)
    assert want is oracle is False
    assert TB.batch_verify(bad_t, rng=random.Random(SEED),
                           device="cpu") is False


@pytest.mark.slow
def test_deferred_batch_settles_through_the_plain_batch(backend):
    backend.use_backend("torch")
    with backend.deferred_batch_verification() as batch:
        for r in _raw(2):
            backend.FastAggregateVerify(*r)
    assert batch.verify(device="cpu", rng=random.Random(1)) is True
    assert [h.result() for h in batch.handles] == [True, True]
