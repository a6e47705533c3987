"""Deneb polynomial commitments: the KZG library (counterpart of the JAX
package's `models/deneb/polynomial_commitments.py`, the executable spec
source of specs/deneb/polynomial-commitments.md: types :61-108,
bit-reversal :112-151, BLS helpers :153-315, polynomial evaluation
:319-351, KZG core :353-640).

A plain importable module: where the JAX package's spec builder supplies
SSZ byte types, `uint64`, `hash` and the preset, this module defines its
own fixed-length `bytes` types and uses `hashlib.sha256`; both presets
pin FIELD_ELEMENTS_PER_BLOB at 4096 (the trusted setup has exactly that
many points).  `bls` is the port's facade: under its default backend
"torch", `g1_lincomb` of 16 or more points runs on the card
(`g1_multi_exp_device`, K14 at 4096), every `pairing_check` runs
`pairing_check_device` (K12 -> K10), and
`evaluate_polynomial_in_evaluation_form` runs K16 (`ops.fr_batch.
barycentric_eval`); `bls.use_backend("py")` gives the host oracle.
"""

from __future__ import annotations

import json
from hashlib import sha256
from pathlib import Path

from ...ops import bls
from ...ops.fr_batch import barycentric_eval

FIELD_ELEMENTS_PER_BLOB = 4096


def hash(data: bytes) -> bytes:  # noqa: A001 - the spec's name
    return sha256(bytes(data)).digest()


class _FixedBytes(bytes):
    """Bytes of one fixed length (the spec's `BytesN` / `ByteVector`)."""

    LENGTH = 0

    def __new__(cls, value=None):
        value = bytes(cls.LENGTH) if value is None else bytes(value)
        if len(value) != cls.LENGTH:
            raise ValueError(f"{cls.__name__}: expected {cls.LENGTH} bytes, "
                             f"got {len(value)}")
        return super().__new__(cls, value)


class Bytes32(_FixedBytes):
    LENGTH = 32


class Bytes48(_FixedBytes):
    LENGTH = 48


class Bytes96(_FixedBytes):
    LENGTH = 96


class G1Point(Bytes48):
    pass


class G2Point(Bytes96):
    pass


class KZGCommitment(Bytes48):
    pass


class KZGProof(Bytes48):
    pass


class BLSFieldElement(bls.Scalar):
    pass


class Polynomial(list):
    def __init__(self, evals=None):
        if evals is None:
            evals = [BLSFieldElement(0)] * FIELD_ELEMENTS_PER_BLOB
        if len(evals) != FIELD_ELEMENTS_PER_BLOB:
            raise ValueError("expected FIELD_ELEMENTS_PER_BLOB evals")
        super().__init__(evals)


# Constants (polynomial-commitments.md :78-89)
BLS_MODULUS = 52435875175126190479447740508185965837690552500527637822603658699938581184513
BYTES_PER_COMMITMENT = 48
BYTES_PER_PROOF = 48
BYTES_PER_FIELD_ELEMENT = 32
BYTES_PER_BLOB = BYTES_PER_FIELD_ELEMENT * FIELD_ELEMENTS_PER_BLOB
G1_POINT_AT_INFINITY = Bytes48(b"\xc0" + b"\x00" * 47)
KZG_ENDIANNESS = "big"
PRIMITIVE_ROOT_OF_UNITY = 7

# Preset (polynomial-commitments.md :91-99); the Fiat-Shamir domains are
# identical across presets
FIAT_SHAMIR_PROTOCOL_DOMAIN = b"FSBLOBVERIFY_V1_"
RANDOM_CHALLENGE_KZG_BATCH_DOMAIN = b"RCKZGBATCH___V1_"


class Blob(_FixedBytes):
    LENGTH = BYTES_PER_FIELD_ELEMENT * FIELD_ELEMENTS_PER_BLOB


# Trusted setup (polynomial-commitments.md :101-108): the standard KZG
# ceremony output, the port's own copy (byte-identical to the JAX
# package's mainnet and minimal copies)
TRUSTED_SETUP_PATH = (Path(__file__).resolve().parents[2] / "presets"
                      / "trusted_setup_4096.json")
_setup = json.loads(TRUSTED_SETUP_PATH.read_text())

KZG_SETUP_G2_LENGTH = 65
KZG_SETUP_G1_MONOMIAL = [G1Point(bytes.fromhex(p[2:]))
                         for p in _setup["g1_monomial"]]
KZG_SETUP_G1_LAGRANGE = [G1Point(bytes.fromhex(p[2:]))
                         for p in _setup["g1_lagrange"]]
KZG_SETUP_G2_MONOMIAL = [G2Point(bytes.fromhex(p[2:]))
                         for p in _setup["g2_monomial"]]
del _setup


# ---------------------------------------------------------------------------
# Bit-reversal permutation (polynomial-commitments.md :112-151)
# ---------------------------------------------------------------------------


def is_power_of_two(value: int) -> bool:
    """Check if ``value`` is a power of two integer."""
    return (value > 0) and (value & (value - 1) == 0)


def reverse_bits(n: int, order: int) -> int:
    """Reverse the bit order of an integer ``n``."""
    assert is_power_of_two(order)
    width = order.bit_length() - 1
    return int(format(n, f"0{width}b")[::-1], 2) if width else 0


def bit_reversal_permutation(sequence):
    """Copy of `sequence` in bit-reversed order (an involution)."""
    return [sequence[reverse_bits(i, len(sequence))]
            for i in range(len(sequence))]


# ---------------------------------------------------------------------------
# BLS12-381 helpers (polynomial-commitments.md :153-315)
# ---------------------------------------------------------------------------


def multi_exp(points, integers):
    """Multi-scalar multiplication in G1 or G2 (delegates to the crypto
    backend's Pippenger MSM)."""
    return bls.multi_exp(points, integers)


def hash_to_bls_field(data: bytes) -> BLSFieldElement:
    """Hash ``data`` to a (non-uniform) BLS scalar."""
    hashed_data = hash(data)
    return BLSFieldElement(
        int.from_bytes(hashed_data, KZG_ENDIANNESS) % BLS_MODULUS)


def bytes_to_bls_field(b: bytes) -> BLSFieldElement:
    """Convert untrusted bytes to a validated field element (rejects
    values >= the modulus)."""
    field_element = int.from_bytes(b, KZG_ENDIANNESS)
    assert field_element < BLS_MODULUS
    return BLSFieldElement(field_element)


def bls_field_to_bytes(x: BLSFieldElement) -> Bytes32:
    return int.to_bytes(int(x), 32, KZG_ENDIANNESS)


def validate_kzg_g1(b: Bytes48) -> None:
    """KeyValidate, but allowing the identity point."""
    if b == G1_POINT_AT_INFINITY:
        return
    assert bls.KeyValidate(b)


def bytes_to_kzg_commitment(b: Bytes48) -> KZGCommitment:
    validate_kzg_g1(b)
    return KZGCommitment(b)


def bytes_to_kzg_proof(b: Bytes48) -> KZGProof:
    validate_kzg_g1(b)
    return KZGProof(b)


def blob_to_polynomial(blob: Blob) -> Polynomial:
    """Convert a blob to a list of BLS field scalars."""
    polynomial = Polynomial()
    for i in range(FIELD_ELEMENTS_PER_BLOB):
        value = bytes_to_bls_field(
            blob[i * BYTES_PER_FIELD_ELEMENT:(i + 1) * BYTES_PER_FIELD_ELEMENT])
        polynomial[i] = value
    return polynomial


def compute_challenge(blob: Blob,
                      commitment: KZGCommitment) -> BLSFieldElement:
    """Fiat-Shamir challenge over (domain, degree, blob, commitment)."""
    # Append the degree of the polynomial as a domain separator
    degree_poly = int.to_bytes(FIELD_ELEMENTS_PER_BLOB, 16, KZG_ENDIANNESS)
    data = FIAT_SHAMIR_PROTOCOL_DOMAIN + degree_poly

    data += blob
    data += commitment

    return hash_to_bls_field(data)


def g1_lincomb(points, scalars) -> KZGCommitment:
    """BLS multiscalar multiplication in G1."""
    assert len(points) == len(scalars)

    if len(points) == 0:
        return bls.G1_to_bytes48(bls.Z1())

    points_g1 = []
    for point in points:
        points_g1.append(bls.bytes48_to_G1(point))

    result = bls.multi_exp(points_g1, scalars)
    return KZGCommitment(bls.G1_to_bytes48(result))


def compute_powers(x: BLSFieldElement, n: int):
    """[x^0, .., x^(n-1)]; empty when n == 0."""
    current_power = BLSFieldElement(1)
    powers = []
    for _ in range(n):
        powers.append(current_power)
        current_power = current_power * x
    return powers


def compute_roots_of_unity(order: int):
    """Roots of unity of ``order``."""
    assert (BLS_MODULUS - 1) % int(order) == 0
    root_of_unity = BLSFieldElement(
        pow(PRIMITIVE_ROOT_OF_UNITY, (BLS_MODULUS - 1) // int(order),
            BLS_MODULUS))
    return compute_powers(root_of_unity, order)


# ---------------------------------------------------------------------------
# Polynomials (polynomial-commitments.md :319-351)
# ---------------------------------------------------------------------------


def evaluate_polynomial_in_evaluation_form(
        polynomial: Polynomial, z: BLSFieldElement) -> BLSFieldElement:
    """Evaluate at `z`: direct lookup inside the domain, barycentric
    formula outside:
    f(z) = (z^W - 1)/W * sum_i f(DOMAIN[i]) * DOMAIN[i] / (z - DOMAIN[i])."""
    width = len(polynomial)
    assert width == FIELD_ELEMENTS_PER_BLOB
    inverse_width = BLSFieldElement(width).inverse()

    roots_of_unity_brp = bit_reversal_permutation(
        compute_roots_of_unity(FIELD_ELEMENTS_PER_BLOB))

    # Inside the domain the answer is just the stored evaluation
    if z in roots_of_unity_brp:
        eval_index = roots_of_unity_brp.index(z)
        return polynomial[eval_index]

    if bls.backend_name() == "torch" and width >= 256:
        # device path: all `width` denominators invert at once (K16,
        # `ops/fr_batch`) on the facade's device; equal to the loop below
        return BLSFieldElement(barycentric_eval(
            [int(v) for v in polynomial],
            [int(r) for r in roots_of_unity_brp], int(z),
            device=bls._device))

    result = BLSFieldElement(0)
    for i in range(width):
        a = polynomial[i] * roots_of_unity_brp[i]
        b = z - roots_of_unity_brp[i]
        result += a / b
    r = z.pow(BLSFieldElement(width)) - BLSFieldElement(1)
    result = result * r * inverse_width
    return result


# ---------------------------------------------------------------------------
# KZG core (polynomial-commitments.md :353-640)
# ---------------------------------------------------------------------------


def blob_to_kzg_commitment(blob: Blob) -> KZGCommitment:
    """Public method."""
    assert len(blob) == BYTES_PER_BLOB
    return g1_lincomb(bit_reversal_permutation(KZG_SETUP_G1_LAGRANGE),
                      blob_to_polynomial(blob))


def verify_kzg_proof(commitment_bytes: Bytes48, z_bytes: Bytes32,
                     y_bytes: Bytes32, proof_bytes: Bytes48) -> bool:
    """Verify that p(z) == y given a commitment and proof (byte inputs).
    Public method."""
    assert len(commitment_bytes) == BYTES_PER_COMMITMENT
    assert len(z_bytes) == BYTES_PER_FIELD_ELEMENT
    assert len(y_bytes) == BYTES_PER_FIELD_ELEMENT
    assert len(proof_bytes) == BYTES_PER_PROOF

    return verify_kzg_proof_impl(
        bytes_to_kzg_commitment(commitment_bytes),
        bytes_to_bls_field(z_bytes),
        bytes_to_bls_field(y_bytes),
        bytes_to_kzg_proof(proof_bytes),
    )


def verify_kzg_proof_impl(commitment: KZGCommitment, z: BLSFieldElement,
                          y: BLSFieldElement, proof: KZGProof) -> bool:
    """Verify: P - y = Q * (X - z) via one pairing check."""
    X_minus_z = bls.add(
        bls.bytes96_to_G2(KZG_SETUP_G2_MONOMIAL[1]),
        bls.multiply(bls.G2(), -z),
    )
    P_minus_y = bls.add(bls.bytes48_to_G1(commitment),
                        bls.multiply(bls.G1(), -y))
    return bls.pairing_check(
        [[P_minus_y, bls.neg(bls.G2())],
         [bls.bytes48_to_G1(proof), X_minus_z]])


def verify_kzg_proof_batch(commitments, zs, ys, proofs) -> bool:
    """Batch verify via a random linear combination folded into a single
    pairing check (polynomial-commitments.md :415-470)."""
    assert len(commitments) == len(zs) == len(ys) == len(proofs)

    # Random challenge (need not be a hash; it must only be unpredictable)
    degree_poly = int.to_bytes(FIELD_ELEMENTS_PER_BLOB, 8, KZG_ENDIANNESS)
    num_commitments = int.to_bytes(len(commitments), 8, KZG_ENDIANNESS)
    data = RANDOM_CHALLENGE_KZG_BATCH_DOMAIN + degree_poly + num_commitments

    for commitment, z, y, proof in zip(commitments, zs, ys, proofs):
        data += commitment + bls_field_to_bytes(z) + bls_field_to_bytes(y) + proof

    r = hash_to_bls_field(data)
    r_powers = compute_powers(r, len(commitments))

    # Verify: e(sum r^i proof_i, [s]) ==
    # e(sum r^i (commitment_i - [y_i]) + sum r^i z_i proof_i, [1])
    proof_lincomb = g1_lincomb(proofs, r_powers)
    proof_z_lincomb = g1_lincomb(
        proofs, [z * r_power for z, r_power in zip(zs, r_powers)])
    C_minus_ys = [
        bls.add(bls.bytes48_to_G1(commitment), bls.multiply(bls.G1(), -y))
        for commitment, y in zip(commitments, ys)
    ]
    C_minus_y_as_KZGCommitments = [
        KZGCommitment(bls.G1_to_bytes48(x)) for x in C_minus_ys]
    C_minus_y_lincomb = g1_lincomb(C_minus_y_as_KZGCommitments, r_powers)

    return bls.pairing_check([
        [bls.bytes48_to_G1(proof_lincomb),
         bls.neg(bls.bytes96_to_G2(KZG_SETUP_G2_MONOMIAL[1]))],
        [bls.add(bls.bytes48_to_G1(C_minus_y_lincomb),
                 bls.bytes48_to_G1(proof_z_lincomb)),
         bls.G2()],
    ])


def compute_kzg_proof(blob: Blob, z_bytes: Bytes32):
    """KZG proof at point `z` for the polynomial represented by `blob`:
    quotient q(x) = (p(x) - p(z)) / (x - z) in evaluation form.
    Public method."""
    assert len(blob) == BYTES_PER_BLOB
    assert len(z_bytes) == BYTES_PER_FIELD_ELEMENT
    polynomial = blob_to_polynomial(blob)
    proof, y = compute_kzg_proof_impl(polynomial, bytes_to_bls_field(z_bytes))
    return proof, int(y).to_bytes(BYTES_PER_FIELD_ELEMENT, KZG_ENDIANNESS)


def compute_quotient_eval_within_domain(z: BLSFieldElement,
                                        polynomial: Polynomial,
                                        y: BLSFieldElement) -> BLSFieldElement:
    """q(z) for z inside the domain (the L'Hopital special case of the
    quotient; see Feist's multiproofs note)."""
    roots_of_unity_brp = bit_reversal_permutation(
        compute_roots_of_unity(FIELD_ELEMENTS_PER_BLOB))
    result = BLSFieldElement(0)
    for i, omega_i in enumerate(roots_of_unity_brp):
        if omega_i == z:  # skip the evaluation point in the sum
            continue

        f_i = polynomial[i] - y
        numerator = f_i * omega_i
        denominator = z * (z - omega_i)
        result += numerator / denominator

    return result


def compute_kzg_proof_impl(polynomial: Polynomial, z: BLSFieldElement):
    """Shared by compute_kzg_proof / compute_blob_kzg_proof."""
    roots_of_unity_brp = bit_reversal_permutation(
        compute_roots_of_unity(FIELD_ELEMENTS_PER_BLOB))

    # For all x_i, compute p(x_i) - p(z)
    y = evaluate_polynomial_in_evaluation_form(polynomial, z)
    polynomial_shifted = [p - y for p in polynomial]

    # For all x_i, compute (x_i - z)
    denominator_poly = [x - z for x in roots_of_unity_brp]

    # Quotient polynomial directly in evaluation form
    quotient_polynomial = [BLSFieldElement(0)] * FIELD_ELEMENTS_PER_BLOB
    for i, (a, b) in enumerate(zip(polynomial_shifted, denominator_poly)):
        if b == BLSFieldElement(0):
            # z is this root of unity: the special in-domain case
            quotient_polynomial[i] = compute_quotient_eval_within_domain(
                roots_of_unity_brp[i], polynomial, y)
        else:
            # q(x_i) = (p(x_i) - p(z)) / (x_i - z)
            quotient_polynomial[i] = a / b

    return KZGProof(g1_lincomb(
        bit_reversal_permutation(KZG_SETUP_G1_LAGRANGE),
        quotient_polynomial)), y


def compute_blob_kzg_proof(blob: Blob,
                           commitment_bytes: Bytes48) -> KZGProof:
    """Proof used to verify a blob against its commitment (does not check
    the commitment itself).  Public method."""
    assert len(blob) == BYTES_PER_BLOB
    assert len(commitment_bytes) == BYTES_PER_COMMITMENT
    commitment = bytes_to_kzg_commitment(commitment_bytes)
    polynomial = blob_to_polynomial(blob)
    evaluation_challenge = compute_challenge(blob, commitment)
    proof, _ = compute_kzg_proof_impl(polynomial, evaluation_challenge)
    return proof


def verify_blob_kzg_proof(blob: Blob, commitment_bytes: Bytes48,
                          proof_bytes: Bytes48) -> bool:
    """Verify a blob against a commitment via its blob proof.
    Public method."""
    assert len(blob) == BYTES_PER_BLOB
    assert len(commitment_bytes) == BYTES_PER_COMMITMENT
    assert len(proof_bytes) == BYTES_PER_PROOF

    commitment = bytes_to_kzg_commitment(commitment_bytes)

    polynomial = blob_to_polynomial(blob)
    evaluation_challenge = compute_challenge(blob, commitment)

    # Evaluate polynomial at `evaluation_challenge`
    y = evaluate_polynomial_in_evaluation_form(polynomial,
                                               evaluation_challenge)

    # Verify proof
    proof = bytes_to_kzg_proof(proof_bytes)
    return verify_kzg_proof_impl(commitment, evaluation_challenge, y, proof)


def verify_blob_kzg_proof_batch(blobs, commitments_bytes,
                                proofs_bytes) -> bool:
    """Batch-verify blobs against commitments; True on empty input.
    Public method."""
    assert len(blobs) == len(commitments_bytes) == len(proofs_bytes)

    commitments, evaluation_challenges, ys, proofs = [], [], [], []
    for blob, commitment_bytes, proof_bytes in zip(blobs, commitments_bytes,
                                                   proofs_bytes):
        assert len(blob) == BYTES_PER_BLOB
        assert len(commitment_bytes) == BYTES_PER_COMMITMENT
        assert len(proof_bytes) == BYTES_PER_PROOF
        commitment = bytes_to_kzg_commitment(commitment_bytes)
        commitments.append(commitment)
        polynomial = blob_to_polynomial(blob)
        evaluation_challenge = compute_challenge(blob, commitment)
        evaluation_challenges.append(evaluation_challenge)
        ys.append(evaluate_polynomial_in_evaluation_form(
            polynomial, evaluation_challenge))
        proofs.append(bytes_to_kzg_proof(proof_bytes))

    return verify_kzg_proof_batch(commitments, evaluation_challenges, ys,
                                  proofs)
