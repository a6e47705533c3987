"""Slice 4 of the port, the precomputed-line pairing check: the host line
precompute and the plain `miller_product_precomp` against the JAX
package's `pairing_jax` (limb for limb, tolerance zero), the plain
`multi_pairing_check_precomp` against JAX's, and the plain
`pairing_check_device(device="cpu")` against the oracle `pairing_check`
on the pairs of `tests/test_bls_kernels.py`'s precomputed-line test
(accepted, rejected, and a pair at infinity).  Kernel K12 is held
against the plain version on the card (`tests/test_torch_cuda.py`,
`chip_smoke.py`).  Then the facade's eager calls over this check under
"torch" on the CPU against "py", accept and reject."""

import jax
import numpy as np
import pytest
import torch

from consensus_specs_tpu.ops.bls import curve as Jcurve
from consensus_specs_tpu.ops.bls_batch import pairing_jax as Jp
from consensus_specs_tpu_torch.ops import bls as TBLS
from consensus_specs_tpu_torch.ops import bls_batch as TB
from consensus_specs_tpu_torch.ops.bls import curve as C
from consensus_specs_tpu_torch.ops.bls import pairing as P
from consensus_specs_tpu_torch.ops.bls_batch import pairing as Tp


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions are thousands of small int32 ops: one intra-op
    thread runs them faster than a pool of one thread per core, and
    keeps parallel test workers from oversubscribing the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


K = 97531


def _pairs(which):
    """`tests/test_bls_kernels.py:145`'s pair sets, as port oracle points."""
    ppt = C.g1.mul(C.G1_GEN, 1337)
    if which == "good":
        return [(ppt, C.g2.mul(C.G2_GEN, K)),
                (C.g1.mul(C.g1.neg(ppt), K), C.G2_GEN)]
    if which == "bad":
        return [(ppt, C.g2.mul(C.G2_GEN, K)),
                (C.g1.mul(C.g1.neg(ppt), K + 1), C.G2_GEN)]
    return [(C.g1.infinity(), C.G2_GEN)]


def test_g2_lines_match_jax():
    for k in (1, K):
        mine = Tp.precompute_g2_lines(C.g2.mul(C.G2_GEN, k))
        ref = Jp.precompute_g2_lines(Jcurve.g2.mul(Jcurve.G2_GEN, k))
        assert mine.dtype == ref.dtype == np.int32
        assert mine.shape == (len(Tp.X_BITS), 6, 2, 33)
        assert np.array_equal(mine, ref)
    q = C.g2.mul(C.G2_GEN, 5)
    assert Tp.precompute_g2_lines(q) is Tp.precompute_g2_lines(q)  # cached
    with pytest.raises(AssertionError):
        Tp.precompute_g2_lines(C.g2.infinity())


def test_pairing_check_inputs_pad_by_repeating_lane_zero():
    pairs = _pairs("good") + [(C.G1_GEN, C.g2.infinity())]
    xp, yp, lines, mask = TB.pairing_check_inputs(pairs)
    assert xp.shape == (8, 33) and lines.shape[:2] == (len(Tp.X_BITS), 8)
    assert mask.tolist() == [True, True] + [False] * 6
    assert (xp[2:] == xp[0]).all() and (lines[:, 2:] == lines[:, :1]).all()
    assert TB.pairing_check_inputs(_pairs("infinity")) is None


def test_miller_product_precomp_matches_jax():
    """Bucket 8 with two live lanes and six masked pad lanes."""
    xp, yp, lines, mask = TB.pairing_check_inputs(_pairs("good"))
    got = Tp.miller_product_precomp(*(torch.from_numpy(a) for a in
                                      (xp, yp, lines, mask)))
    want = jax.jit(Jp.miller_product_precomp)(xp, yp, lines, mask)
    assert got.shape == (2, 3, 2, 33)
    assert np.array_equal(got.numpy(), np.asarray(want))


_jax_precomp_check = jax.jit(Jp.multi_pairing_check_precomp)


@pytest.mark.parametrize("which", ["good", "bad"])
def test_multi_pairing_check_precomp_matches_jax(which):
    """The plain route of `pairing_check_device`, accept and reject."""
    arrays = TB.pairing_check_inputs(_pairs(which))
    got = Tp.multi_pairing_check_precomp(*(torch.from_numpy(a)
                                           for a in arrays))
    want = bool(_jax_precomp_check(*arrays))
    assert want is (which == "good")
    assert got.dtype == torch.bool and bool(got) is want


@pytest.mark.parametrize("which", ["good", "bad", "infinity"])
def test_pairing_check_device_matches_the_oracle(which):
    pairs = _pairs(which)
    want = P.pairing_check(pairs)
    assert want is {"good": True, "bad": False, "infinity": True}[which]
    assert TB.pairing_check_device(pairs, device="cpu") is want


def test_pairing_check_device_runs_on_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the card tests cover it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TB.pairing_check_device(_pairs("good"))


# --- the facade's eager calls -------------------------------------------------


@pytest.fixture
def backend(monkeypatch):
    """The facade with its "torch" routes on the CPU (plain versions)."""
    monkeypatch.setattr(TBLS, "_device", "cpu")
    saved = TBLS.backend_name()
    yield TBLS
    TBLS.use_backend(saved)


def _eager_case(name, accept):
    """(callable args) for one of the facade's eager calls: three keys
    signing one message (or one per key), rejected by a wrong message."""
    cs = TBLS._py
    sks = [11, 12, 13]
    msg, other = b"\x05" * 32, b"\x06" * 32
    pks = [cs.SkToPk(sk) for sk in sks]
    if name == "Verify":
        return (pks[0], msg if accept else other, cs.Sign(sks[0], msg))
    if name == "FastAggregateVerify":
        sig = cs.Aggregate([cs.Sign(sk, msg) for sk in sks])
        return (pks, msg if accept else other, sig)
    if name == "AggregateVerify":
        msgs = [bytes([i]) * 32 for i in range(3)]
        sig = cs.Aggregate([cs.Sign(sk, m) for sk, m in zip(sks, msgs)])
        return (pks, msgs if accept else msgs[:2] + [other], sig)
    g1 = cs.G1()
    return ([((1, C.g1.mul(g1[1], 3)), cs.G2()),
             (cs.neg(g1), cs.multiply(cs.G2(), 3 if accept else 4))],)


@pytest.mark.parametrize("accept", [True, False])
@pytest.mark.parametrize("name", ["Verify", "FastAggregateVerify",
                                  "AggregateVerify", "pairing_check"])
def test_facade_eager_calls_on_the_device_match_py(backend, name, accept):
    args = _eager_case(name, accept)
    backend.use_backend("py")
    want = getattr(backend, name)(*args)
    assert want is accept
    backend.use_backend("torch")
    assert getattr(backend, name)(*args) is want
