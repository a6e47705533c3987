"""Slice 5 of the port, Deneb's KZG library
(`consensus_specs_tpu_torch/models/deneb/polynomial_commitments.py`)
against the JAX package's executable spec, `build_spec("deneb",
"minimal")` (W = 4096): the trusted setup copy, bit reversal, the
Fiat-Shamir challenges, `Scalar` arithmetic, the evaluation at 4096
points (the host loop, and K16's plain version under the "torch"
backend), and the verify functions' verdicts on valid and tampered
input.  Exact arithmetic, so the tolerance is zero.

The blobs are closed forms of degree <= 1, f = a X + b: the commitment is
a [s] + b [1] (monomial setup points 1 and 0) and the proof at every z is
a [1], so no host needs a 4096-point MSM; `blob_to_kzg_commitment` and
`compute_blob_kzg_proof`, which do, are `@slow`."""

import functools
import hashlib
import random
from pathlib import Path

import pytest
import torch

from consensus_specs_tpu.models.builder import build_spec
from consensus_specs_tpu.ops import bls as jbls
from consensus_specs_tpu_torch.models.deneb import polynomial_commitments as P
from consensus_specs_tpu_torch.ops import bls as tbls
from consensus_specs_tpu_torch.ops.bls import curve as C

REPO = Path(__file__).resolve().parents[1]
R = P.BLS_MODULUS


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions are thousands of small int32 ops: one intra-op
    thread runs them faster than a pool of one thread per core, and
    keeps parallel test workers from oversubscribing the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def spec():
    return build_spec("deneb", "minimal")


@pytest.fixture()
def real_bls():
    prev = jbls.bls_active
    jbls.bls_active = True
    yield
    jbls.bls_active = prev


@pytest.fixture()
def backend(monkeypatch):
    """Sets the port's facade backend; "torch" runs its plain versions
    on the CPU."""
    def use(name):
        monkeypatch.setattr(tbls, "_backend_name", name)
        monkeypatch.setattr(tbls, "_device", "cpu")
    return use


@functools.cache
def _roots_brp():
    return [int(r) for r in P.bit_reversal_permutation(
        P.compute_roots_of_unity(P.FIELD_ELEMENTS_PER_BLOB))]


@functools.cache
def _linear_blob(a: int, b: int):
    """(blob, commitment, proof) of f = a X + b."""
    blob = b"".join(int.to_bytes((a * x + b) % R, 32, "big")
                    for x in _roots_brp())
    s1 = C.g1_from_bytes(P.KZG_SETUP_G1_MONOMIAL[1])
    s0 = C.g1_from_bytes(P.KZG_SETUP_G1_MONOMIAL[0])
    commitment = C.g1_to_bytes(C.g1.add(C.g1.mul(s1, a), C.g1.mul(s0, b)))
    return blob, commitment, C.g1_to_bytes(C.g1.mul(s0, a))


def test_trusted_setup_copy_is_byte_identical_to_both_jax_copies():
    port = P.TRUSTED_SETUP_PATH.read_bytes()
    assert len(port) == 881_553
    digest = hashlib.sha256(port).hexdigest()
    for preset in ("mainnet", "minimal"):
        jax_copy = (REPO / "consensus_specs_tpu" / "presets" / preset
                    / "trusted_setups" / "trusted_setup_4096.json")
        assert hashlib.sha256(jax_copy.read_bytes()).hexdigest() == digest


def test_constants_and_setup_match_the_spec(spec):
    assert P.BLS_MODULUS == int(spec.BLS_MODULUS)
    assert P.FIELD_ELEMENTS_PER_BLOB == int(spec.FIELD_ELEMENTS_PER_BLOB)
    assert P.BYTES_PER_BLOB == int(spec.BYTES_PER_BLOB)
    assert bytes(P.G1_POINT_AT_INFINITY) == bytes(spec.G1_POINT_AT_INFINITY)
    for name in ("KZG_SETUP_G1_MONOMIAL", "KZG_SETUP_G1_LAGRANGE",
                 "KZG_SETUP_G2_MONOMIAL"):
        assert [bytes(p) for p in getattr(P, name)] == \
            [bytes(p) for p in getattr(spec, name)], name
    for name in ("FIAT_SHAMIR_PROTOCOL_DOMAIN",
                 "RANDOM_CHALLENGE_KZG_BATCH_DOMAIN"):
        assert getattr(P, name) == bytes(getattr(spec, name))
    with pytest.raises(ValueError):
        P.KZGProof(b"\x00" * 47)


def test_bit_reversal_matches_the_spec(spec):
    for order in (1, 2, 8, 64, 4096):
        for n in (0, 1, order // 2, order - 1):
            assert P.reverse_bits(n, order) == spec.reverse_bits(n, order)
    seq = list(range(64))
    assert P.bit_reversal_permutation(seq) == \
        list(spec.bit_reversal_permutation(seq))
    assert _roots_brp() == [int(r) for r in spec.bit_reversal_permutation(
        spec.compute_roots_of_unity(spec.FIELD_ELEMENTS_PER_BLOB))]
    assert [P.is_power_of_two(v) for v in (0, 1, 6, 64)] == \
        [False, True, False, True]


def test_challenges_and_hash_to_field_match_the_spec(spec):
    blob, commitment, _ = _linear_blob(5, 7)
    assert int(P.compute_challenge(P.Blob(blob), P.KZGCommitment(
        commitment))) == int(spec.compute_challenge(
            spec.Blob(blob), spec.KZGCommitment(commitment)))
    for data in (b"", b"abc", bytes(range(200))):
        assert int(P.hash_to_bls_field(data)) == \
            int(spec.hash_to_bls_field(data))
    z = P.bytes_to_bls_field(int.to_bytes(R - 1, 32, "big"))
    assert int(z) == R - 1
    with pytest.raises(AssertionError):
        P.bytes_to_bls_field(int.to_bytes(R, 32, "big"))
    assert P.bls_field_to_bytes(z) == bytes(spec.bls_field_to_bytes(
        spec.BLSFieldElement(R - 1)))


def test_scalar_arithmetic_matches_the_spec(spec):
    rng = random.Random(5)
    vals = [0, 1, R - 1] + [rng.randrange(R) for _ in range(5)]
    for x in vals:
        for y in vals:
            a, b = P.BLSFieldElement(x), P.BLSFieldElement(y)
            ja, jb = spec.BLSFieldElement(x), spec.BLSFieldElement(y)
            assert int(a + b) == int(ja + jb)
            assert int(a - b) == int(ja - jb)
            assert int(a * b) == int(ja * jb)
            assert int(3 - a) == int(3 - ja) and int(-a) == int(-ja)
            assert type(a + b) is P.BLSFieldElement
            if y:
                assert int(a / b) == int(ja / jb)
                assert int(b.inverse()) == int(jb.inverse())
                assert int(5 / b) == int(5 / jb)
            assert int(a.pow(y)) == int(ja.pow(jb))
    assert P.BLSFieldElement(R + 3) == 3 and isinstance(
        P.BLSFieldElement(1), tbls.Scalar)
    powers = P.compute_powers(P.BLSFieldElement(7), 5)
    assert [int(p) for p in powers] == [int(p) for p in spec.compute_powers(
        spec.BLSFieldElement(7), 5)]


def test_evaluate_in_evaluation_form_at_4096(spec, backend):
    """The host loop, K16's plain version ("torch" backend on the CPU) and
    the spec on both of its backends give the same value; a z inside the
    domain returns the stored evaluation."""
    rng = random.Random(6)
    evals = [rng.randrange(R) for _ in range(P.FIELD_ELEMENTS_PER_BLOB)]
    z = rng.randrange(R)
    want = int(spec.evaluate_polynomial_in_evaluation_form(
        spec.Polynomial([spec.BLSFieldElement(v) for v in evals]),
        spec.BLSFieldElement(z)))
    prev = jbls.backend_name()
    jbls.use_backend("jax")
    try:
        assert int(spec.evaluate_polynomial_in_evaluation_form(
            spec.Polynomial([spec.BLSFieldElement(v) for v in evals]),
            spec.BLSFieldElement(z))) == want
    finally:
        jbls.use_backend(prev)
    poly = P.Polynomial([P.BLSFieldElement(v) for v in evals])
    for name in ("py", "torch"):
        backend(name)
        got = P.evaluate_polynomial_in_evaluation_form(
            poly, P.BLSFieldElement(z))
        assert type(got) is P.BLSFieldElement and int(got) == want, name
    root = P.BLSFieldElement(_roots_brp()[17])
    assert int(P.evaluate_polynomial_in_evaluation_form(poly, root)) == \
        evals[17]


def test_verify_blob_kzg_proof_batch_verdicts_match_the_spec(spec, backend,
                                                             real_bls):
    """Valid, proofs swapped and a wrong blob, on the port's "py" backend,
    and the valid batch through K16's and K12 -> K10's plain versions
    ("torch" on the CPU); each verdict equals the spec's."""
    items = [_linear_blob(5, 7), _linear_blob(11, 2)]
    blobs = [b for b, _, _ in items]
    coms = [c for _, c, _ in items]
    proofs = [p for _, _, p in items]
    cases = [(blobs, proofs, True), (blobs, proofs[::-1], False),
             ([blobs[0], blobs[0]], proofs, False)]
    backend("py")
    for bl, pr, want in cases:
        assert spec.verify_blob_kzg_proof_batch(
            [spec.Blob(b) for b in bl], coms, pr) is want
        assert P.verify_blob_kzg_proof_batch(bl, coms, pr) is want
    assert P.verify_blob_kzg_proof(blobs[1], coms[1], proofs[1]) is True
    assert P.verify_blob_kzg_proof_batch([], [], []) is True
    backend("torch")
    assert P.verify_blob_kzg_proof_batch(blobs, coms, proofs) is True


def test_verify_kzg_proof_verdicts_match_the_spec(spec, backend, real_bls):
    """verify_kzg_proof at a z outside the domain with the right y and
    with y + 1, on both port backends (the pairing through K12 -> K10's
    plain versions under "torch")."""
    a, b = 9, 4
    _, commitment, proof = _linear_blob(a, b)
    z = 0xC0FFEE
    y = (a * z + b) % R
    for name in ("py", "torch"):
        backend(name)
        for yy, want in ((y, True), ((y + 1) % R, False)):
            args = (commitment, int.to_bytes(z, 32, "big"),
                    int.to_bytes(yy, 32, "big"), proof)
            assert P.verify_kzg_proof(*args) is want, (name, yy)
            assert spec.verify_kzg_proof(*args) is want


@pytest.mark.slow
def test_commitment_and_blob_proof_match_the_spec(spec, backend, real_bls):
    """The 4096-point MSMs of `blob_to_kzg_commitment` and
    `compute_blob_kzg_proof` (host oracle) against the spec and the
    closed forms, and the verdict on them."""
    backend("py")
    blob, commitment, proof = _linear_blob(3, 8)
    got = P.blob_to_kzg_commitment(P.Blob(blob))
    assert bytes(got) == commitment == bytes(spec.blob_to_kzg_commitment(
        spec.Blob(blob)))
    got_proof = P.compute_blob_kzg_proof(P.Blob(blob), got)
    assert bytes(got_proof) == proof == bytes(spec.compute_blob_kzg_proof(
        spec.Blob(blob), spec.KZGCommitment(commitment)))
    z = int.to_bytes(12345, 32, "big")
    proof_z, y = P.compute_kzg_proof(P.Blob(blob), z)
    want_proof, want_y = spec.compute_kzg_proof(spec.Blob(blob), z)
    assert (bytes(proof_z), bytes(y)) == (bytes(want_proof), bytes(want_y))
    assert P.verify_blob_kzg_proof_batch([blob], [commitment], [proof])
