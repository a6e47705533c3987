"""Host-side DAS statement parsing (counterpart of the JAX package's
`das/ciphersuite.py`): the fulu sampling spec's wire boundary.

Mirrors `verify_cell_kzg_proof_batch`'s front half exactly (the same
asserts, the same dedup expression, the same Fiat-Shamir serialization),
so the device route in `das.verify` starts from the statement the oracle
verifies.  Also holds the coset machinery the kernels need in host-int
form: `coset_shift(k)` / `coset_points(k)` (the brp domain slice IS
h_k * (order-64 subgroup in bit-reversed order), so nothing is re-sorted),
the rev-folded inverse-DFT matrix behind `ops.fr_batch.
coset_interpolate_sum`, and the closed-form sampling matrices
(degree-65 polynomials: every cell, proof and commitment a 1-3
scalar-multiplication closed form).
"""

from __future__ import annotations

import functools
import json
from dataclasses import dataclass
from hashlib import sha256
from pathlib import Path

from ..ops.bls import ciphersuite as _bls_cs
from ..ops.bls import curve as _curve

# the scalar field (the KZG BLS_MODULUS), the modulus of `ops.fr_batch`
BLS_MODULUS = _curve.R
PRIMITIVE_ROOT_OF_UNITY = 7

# both checked-in presets pin the mainnet polynomial degree (the
# trusted setup has exactly this many monomial points)
FIELD_ELEMENTS_PER_BLOB = 4096
FIELD_ELEMENTS_PER_CELL = 64
FIELD_ELEMENTS_PER_EXT_BLOB = 2 * FIELD_ELEMENTS_PER_BLOB
CELLS_PER_EXT_BLOB = FIELD_ELEMENTS_PER_EXT_BLOB // FIELD_ELEMENTS_PER_CELL

BYTES_PER_FIELD_ELEMENT = 32
BYTES_PER_CELL = FIELD_ELEMENTS_PER_CELL * BYTES_PER_FIELD_ELEMENT
BYTES_PER_COMMITMENT = 48
BYTES_PER_PROOF = 48
KZG_ENDIANNESS = "big"
RANDOM_CHALLENGE_KZG_CELL_BATCH_DOMAIN = b"RCKZGCBATCH__V1_"
G1_POINT_AT_INFINITY = b"\xc0" + b"\x00" * 47

_SETUP_PATH = (Path(__file__).resolve().parents[1] / "presets"
               / "trusted_setup_4096.json")


# --- trusted setup (parsed lazily; the ceremony output is trusted) ----------


@functools.lru_cache(maxsize=1)
def _setup_json() -> dict:
    return json.loads(_SETUP_PATH.read_text())


@functools.lru_cache(maxsize=1)
def setup_g1_monomial_bytes() -> tuple[bytes, ...]:
    """The 4096 monomial G1 points [s^t] as compressed bytes."""
    return tuple(bytes.fromhex(p[2:]) for p in _setup_json()["g1_monomial"])


@functools.lru_cache(maxsize=8192)
def setup_g1_point(t: int):
    """[s^t] as an oracle Jacobian point (parsed on demand — the verify
    path needs only the first FIELD_ELEMENTS_PER_CELL of them)."""
    return _curve.g1_from_bytes(setup_g1_monomial_bytes()[t])


@functools.lru_cache(maxsize=4)
def setup_g2_point(n: int):
    """[s^n] in G2 (the verify equation pairs against [s^64] and [1])."""
    return _curve.g2_from_bytes(
        bytes.fromhex(_setup_json()["g2_monomial"][n][2:]))


# --- roots of unity / cosets -------------------------------------------------


def reverse_bits(n: int, order: int) -> int:
    width = order.bit_length() - 1
    return int(format(n, f"0{width}b")[::-1], 2) if width else 0


@functools.lru_cache(maxsize=4)
def _root_of_unity(order: int) -> int:
    assert (BLS_MODULUS - 1) % order == 0
    return pow(PRIMITIVE_ROOT_OF_UNITY, (BLS_MODULUS - 1) // order,
               BLS_MODULUS)


@functools.lru_cache(maxsize=4)
def roots_of_unity(order: int) -> tuple[int, ...]:
    w = _root_of_unity(order)
    out, cur = [], 1
    for _ in range(order):
        out.append(cur)
        cur = cur * w % BLS_MODULUS
    return tuple(out)


def coset_shift(cell_index: int) -> int:
    """h_k — the extended-domain brp element opening cell k's coset
    (`coset_shift_for_cell` in the spec oracle)."""
    assert 0 <= cell_index < CELLS_PER_EXT_BLOB
    return roots_of_unity(FIELD_ELEMENTS_PER_EXT_BLOB)[
        reverse_bits(cell_index, CELLS_PER_EXT_BLOB)]


@functools.lru_cache(maxsize=CELLS_PER_EXT_BLOB + 2)
def coset_points(cell_index: int) -> tuple[int, ...]:
    """Cell k's evaluation points IN STORED ORDER (the brp domain
    slice): point j = h_k * eta^rev6(j), eta the order-64 root.  This
    is exactly `coset_for_cell` — the identity the device kernels lean
    on so no host-side re-sort ever happens."""
    h = coset_shift(cell_index)
    eta = roots_of_unity(FIELD_ELEMENTS_PER_CELL)
    return tuple(h * eta[reverse_bits(j, FIELD_ELEMENTS_PER_CELL)]
                 % BLS_MODULUS for j in range(FIELD_ELEMENTS_PER_CELL))


@functools.lru_cache(maxsize=1)
def coset_idft_matrix() -> tuple[tuple[int, ...], ...]:
    """M[i][j] with coeffs(I)[j] = h^-j * sum_i evals[i] * M[i][j] for
    evals given in STORED (bit-reversed coset) order: the 64-point
    inverse DFT with the rev6 permutation folded in, shared by the host
    oracle route and `fr_batch.coset_interpolate_sum`."""
    n = FIELD_ELEMENTS_PER_CELL
    eta_inv = pow(_root_of_unity(n), BLS_MODULUS - 2, BLS_MODULUS)
    inv_n = pow(n, BLS_MODULUS - 2, BLS_MODULUS)
    pows = [pow(eta_inv, t, BLS_MODULUS) for t in range(n)]
    return tuple(
        tuple(inv_n * pows[(j * reverse_bits(i, n)) % n] % BLS_MODULUS
              for j in range(n))
        for i in range(n))


def interpolate_coset_coeffs(cell_index: int, evals) -> list[int]:
    """Coefficients of the degree-<64 interpolant of `evals` (stored
    order) over cell `cell_index`'s coset — the host reference for the
    device kernel, bit-equal to the oracle's
    `interpolate_polynomialcoeff(coset_for_cell(k), evals)`."""
    m = coset_idft_matrix()
    h_inv = pow(coset_shift(cell_index), BLS_MODULUS - 2, BLS_MODULUS)
    coeffs = []
    hp = 1
    n = FIELD_ELEMENTS_PER_CELL
    for j in range(n):
        acc = 0
        for i in range(n):
            acc += evals[i] * m[i][j]
        coeffs.append(acc % BLS_MODULUS * hp % BLS_MODULUS)
        hp = hp * h_inv % BLS_MODULUS
    return coeffs


# --- Fiat-Shamir -------------------------------------------------------------


def compute_challenge(dedup_commitments, commitment_indices, cell_indices,
                      evals_per_cell, proofs_bytes) -> int:
    """`compute_verify_cell_kzg_proof_batch_challenge`, byte-for-byte."""
    data = RANDOM_CHALLENGE_KZG_CELL_BATCH_DOMAIN
    data += int.to_bytes(FIELD_ELEMENTS_PER_BLOB, 8, KZG_ENDIANNESS)
    data += int.to_bytes(FIELD_ELEMENTS_PER_CELL, 8, KZG_ENDIANNESS)
    data += int.to_bytes(len(dedup_commitments), 8, KZG_ENDIANNESS)
    data += int.to_bytes(len(cell_indices), 8, KZG_ENDIANNESS)
    for commitment in dedup_commitments:
        data += commitment
    for k, evals in enumerate(evals_per_cell):
        data += int.to_bytes(int(commitment_indices[k]), 8, KZG_ENDIANNESS)
        data += int.to_bytes(int(cell_indices[k]), 8, KZG_ENDIANNESS)
        for e in evals:
            data += int.to_bytes(e, BYTES_PER_FIELD_ELEMENT, KZG_ENDIANNESS)
        data += proofs_bytes[k]
    return int.from_bytes(sha256(data).digest(), KZG_ENDIANNESS) \
        % BLS_MODULUS


# --- statement parsing -------------------------------------------------------


def _validate_kzg_g1(b: bytes):
    """The oracle's `validate_kzg_g1` + point parse: infinity is legal,
    anything else must KeyValidate (on curve, in subgroup, not
    infinity).  Raises AssertionError exactly where the oracle does."""
    if bytes(b) == G1_POINT_AT_INFINITY:
        return _curve.g1.infinity()
    assert _bls_cs.KeyValidate(bytes(b))
    return _curve.g1_from_bytes(bytes(b))


@dataclass
class CellBatch:
    """One parsed batch of cell statements, oracle-aligned: the
    deduplicated commitment list, the index mapping into it, unpacked
    coset evaluations, and the Fiat-Shamir challenge every verifier
    term weights by."""

    n_cells: int
    commitment_bytes: list      # deduplicated, oracle dedup order
    commitments: list           # parsed Jacobian points, same order
    commitment_indices: list
    cell_indices: list
    evals: list                 # per cell: 64 ints (stored coset order)
    proof_bytes: list
    proofs: list                # parsed Jacobian points
    r: int
    r_powers: list
    shifts: list                # h_k per cell

    def weights(self) -> list[int]:
        """Per-deduped-commitment folded RLC weights (the RLC term)."""
        w = [0] * len(self.commitments)
        for k in range(self.n_cells):
            w[self.commitment_indices[k]] = (
                w[self.commitment_indices[k]] + self.r_powers[k]) \
                % BLS_MODULUS
        return w

    def weighted_r_powers(self) -> list[int]:
        """r^k * h_k^n per cell (the RLP term's proof scalars)."""
        n = FIELD_ELEMENTS_PER_CELL
        return [rp * pow(h, n, BLS_MODULUS) % BLS_MODULUS
                for rp, h in zip(self.r_powers, self.shifts)]


def parse_cell_batch(commitments_bytes, cell_indices, cells,
                     proofs_bytes) -> CellBatch:
    """Validate one `verify_cell_kzg_proof_batch` argument tuple and
    unpack it for the verifiers.  Mirrors the oracle's front half
    assert-for-assert (malformed input raises AssertionError on both
    paths — pinned by tests/test_torch_das.py)."""
    assert (len(commitments_bytes) == len(cells) == len(proofs_bytes)
            == len(cell_indices))
    for commitment_bytes in commitments_bytes:
        assert len(commitment_bytes) == BYTES_PER_COMMITMENT
    for cell_index in cell_indices:
        assert int(cell_index) < CELLS_PER_EXT_BLOB
    for cell in cells:
        assert len(cell) == BYTES_PER_CELL
    for proof_bytes in proofs_bytes:
        assert len(proof_bytes) == BYTES_PER_PROOF

    # dedup with the oracle's exact expression (same in-process set
    # order, so the Fiat-Shamir challenge matches bit-for-bit)
    dedup_bytes = [bytes(c) for c in set(
        bytes(cb) for cb in commitments_bytes)]
    dedup_points = [_validate_kzg_g1(cb) for cb in dedup_bytes]
    commitment_indices = [dedup_bytes.index(bytes(cb))
                          for cb in commitments_bytes]

    evals = []
    for cell in cells:
        cell = bytes(cell)
        row = []
        for i in range(FIELD_ELEMENTS_PER_CELL):
            e = int.from_bytes(
                cell[i * BYTES_PER_FIELD_ELEMENT:
                     (i + 1) * BYTES_PER_FIELD_ELEMENT], KZG_ENDIANNESS)
            assert e < BLS_MODULUS
            row.append(e)
        evals.append(row)
    proof_bytes = [bytes(p) for p in proofs_bytes]
    proofs = [_validate_kzg_g1(p) for p in proof_bytes]

    cell_indices = [int(i) for i in cell_indices]
    r = compute_challenge(dedup_bytes, commitment_indices, cell_indices,
                          evals, proof_bytes)
    r_powers, cur = [], 1
    for _ in range(len(cell_indices)):
        r_powers.append(cur)
        cur = cur * r % BLS_MODULUS
    return CellBatch(
        n_cells=len(cell_indices),
        commitment_bytes=dedup_bytes,
        commitments=dedup_points,
        commitment_indices=commitment_indices,
        cell_indices=cell_indices,
        evals=evals,
        proof_bytes=proof_bytes,
        proofs=proofs,
        r=r,
        r_powers=r_powers,
        shifts=[coset_shift(i) for i in cell_indices],
    )


# --- closed-form sampling matrices ------------------------------------------


def _encode_evals(evals) -> bytes:
    return b"".join(int.to_bytes(e, BYTES_PER_FIELD_ELEMENT,
                                 KZG_ENDIANNESS) for e in evals)


def closed_form_row(c2: int, c1: int, c0: int, columns):
    """(commitment, {column: (cell, proof)}) for the degree-65
    polynomial f = c2*X^65 + c1*X^64 + c0.

    On cell k's coset every point satisfies x^64 = h_k^64 =: a_k, so
    f|coset = c2*a_k*x + c1*a_k + c0, the quotient by Z_k = X^64 - a_k
    is exactly c2*X + c1 for EVERY cell, and hence
    proof_k = c2*[s] + c1*[1] and commitment = c2*[s^65] + c1*[s^64]
    + c0*[1] — real, non-infinity pairing statements from three scalar
    multiplications, no MSM.  The sampling matrices of `chip_smoke.py` are
    built from these so matrix construction never dominates the
    measured verification."""
    g1 = _curve.g1
    c2, c1, c0 = (c2 % BLS_MODULUS, c1 % BLS_MODULUS, c0 % BLS_MODULUS)
    commitment = g1.add(
        g1.add(g1.mul(setup_g1_point(65), c2),
               g1.mul(setup_g1_point(64), c1)),
        g1.mul(setup_g1_point(0), c0))
    proof = g1.add(g1.mul(setup_g1_point(1), c2),
                   g1.mul(setup_g1_point(0), c1))
    commitment_b = _curve.g1_to_bytes(commitment)
    proof_b = _curve.g1_to_bytes(proof)
    out = {}
    for k in columns:
        a_k = pow(coset_shift(k), FIELD_ELEMENTS_PER_CELL, BLS_MODULUS)
        evals = [(c2 * a_k % BLS_MODULUS * x + c1 * a_k + c0)
                 % BLS_MODULUS for x in coset_points(k)]
        out[k] = (_encode_evals(evals), proof_b)
    return commitment_b, out


def closed_form_matrix(n_blobs: int, columns=None, seed: int = 20250):
    """A full sampling matrix — `n_blobs` rows x `columns` (default all
    128) — as flat, oracle-shaped argument lists
    (commitments, cell_indices, cells, proofs), one entry per sampled
    cell, row-major.  Distinct rows get distinct commitments."""
    if columns is None:
        columns = range(CELLS_PER_EXT_BLOB)
    columns = [int(c) for c in columns]
    commitments, cell_indices, cells, proofs = [], [], [], []
    for row in range(n_blobs):
        commitment_b, per_cell = closed_form_row(
            seed + 3 * row + 1, seed + 3 * row + 2, seed + 3 * row + 3,
            columns)
        for k in columns:
            cell_b, proof_b = per_cell[k]
            commitments.append(commitment_b)
            cell_indices.append(k)
            cells.append(cell_b)
            proofs.append(proof_b)
    return commitments, cell_indices, cells, proofs
