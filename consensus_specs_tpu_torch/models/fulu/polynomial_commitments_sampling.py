"""Fulu polynomial commitments sampling: PeerDAS's KZG library
(counterpart of the JAX package's `models/fulu/polynomial_commitments_
sampling.py`, the executable spec source of specs/fulu/
polynomial-commitments-sampling.md: types :73-103, FFTs :137-243,
coefficient polynomials :245-363, multiproofs :365-509, cosets :511-551,
cells :553-668, reconstruction :670-817).

A plain importable module beside the port's Deneb KZG library
(`models/deneb/polynomial_commitments.py`), built the same way: its own
fixed-length byte types and the Deneb module's helpers where the JAX
package's spec builder would merge the forks.  Under the port's BLS
facade backend "torch" (the default) with real BLS active,
`compute_cells_and_kzg_proofs`, `verify_cell_kzg_proof_batch` and
`recover_cells_and_kzg_proofs` route to the port's `das` (FK20 and the
device decode, the batched cell verify) on the facade's device; the
functions below them are the oracle, which `das.recover`'s host route
runs.
"""

from __future__ import annotations

from ...ops import bls
from ..deneb.polynomial_commitments import (  # noqa: F401
    BLS_MODULUS,
    BYTES_PER_BLOB,
    BYTES_PER_COMMITMENT,
    BYTES_PER_FIELD_ELEMENT,
    BYTES_PER_PROOF,
    FIELD_ELEMENTS_PER_BLOB,
    KZG_ENDIANNESS,
    KZG_SETUP_G1_MONOMIAL,
    KZG_SETUP_G2_MONOMIAL,
    PRIMITIVE_ROOT_OF_UNITY,
    Blob,
    BLSFieldElement,
    KZGProof,
    Polynomial,
    _FixedBytes,
    bit_reversal_permutation,
    blob_to_polynomial,
    bls_field_to_bytes,
    bytes_to_bls_field,
    bytes_to_kzg_commitment,
    bytes_to_kzg_proof,
    compute_powers,
    compute_roots_of_unity,
    g1_lincomb,
    hash_to_bls_field,
    reverse_bits,
)

# ---------------------------------------------------------------------------
# Types + preset (sampling.md :73-103)
# ---------------------------------------------------------------------------

FIELD_ELEMENTS_PER_EXT_BLOB = 2 * FIELD_ELEMENTS_PER_BLOB
FIELD_ELEMENTS_PER_CELL = 64
BYTES_PER_CELL = FIELD_ELEMENTS_PER_CELL * BYTES_PER_FIELD_ELEMENT
CELLS_PER_EXT_BLOB = FIELD_ELEMENTS_PER_EXT_BLOB // FIELD_ELEMENTS_PER_CELL
RANDOM_CHALLENGE_KZG_CELL_BATCH_DOMAIN = b"RCKZGCBATCH__V1_"


class Cell(_FixedBytes):
    LENGTH = BYTES_PER_FIELD_ELEMENT * FIELD_ELEMENTS_PER_CELL


class CellIndex(int):
    pass


class CommitmentIndex(int):
    pass


class PolynomialCoeff(list):
    """A polynomial in coefficient form (bounded by the extended blob)."""

    def __init__(self, coeffs=()):
        assert len(coeffs) <= FIELD_ELEMENTS_PER_EXT_BLOB
        super().__init__(coeffs)


class Coset(list):
    """The evaluation domain of a cell."""

    def __init__(self, evals=None):
        if evals is None:
            evals = [BLSFieldElement(0)] * FIELD_ELEMENTS_PER_CELL
        assert len(evals) == FIELD_ELEMENTS_PER_CELL
        super().__init__(evals)


class CosetEvals(list):
    """A cell's evaluations over its coset."""

    def __init__(self, evals=None):
        if evals is None:
            evals = [BLSFieldElement(0)] * FIELD_ELEMENTS_PER_CELL
        assert len(evals) == FIELD_ELEMENTS_PER_CELL
        super().__init__(evals)


# ---------------------------------------------------------------------------
# BLS helpers (sampling.md :107-135)
# ---------------------------------------------------------------------------


def cell_to_coset_evals(cell: Cell) -> CosetEvals:
    """Convert an untrusted ``Cell`` into a trusted ``CosetEvals``."""
    evals = CosetEvals()
    for i in range(FIELD_ELEMENTS_PER_CELL):
        start = i * BYTES_PER_FIELD_ELEMENT
        end = (i + 1) * BYTES_PER_FIELD_ELEMENT
        evals[i] = bytes_to_bls_field(cell[start:end])
    return evals


def coset_evals_to_cell(coset_evals: CosetEvals) -> Cell:
    """Convert a trusted ``CosetEvals`` into an untrusted ``Cell``."""
    cell = []
    for i in range(FIELD_ELEMENTS_PER_CELL):
        cell += bls_field_to_bytes(coset_evals[i])
    return Cell(bytes(cell))


# ---------------------------------------------------------------------------
# FFTs (sampling.md :137-243)
# ---------------------------------------------------------------------------


def _fft_field(vals, roots_of_unity):
    if len(vals) == 1:
        return vals
    L = _fft_field(vals[::2], roots_of_unity[::2])
    R = _fft_field(vals[1::2], roots_of_unity[::2])
    o = [BLSFieldElement(0) for _ in vals]
    for i, (x, y) in enumerate(zip(L, R)):
        y_times_root = y * roots_of_unity[i]
        o[i] = x + y_times_root
        o[i + len(L)] = x - y_times_root
    return o


def fft_field(vals, roots_of_unity, inv: bool = False):
    if inv:
        # Inverse FFT
        invlen = BLSFieldElement(len(vals)).pow(
            BLSFieldElement(BLS_MODULUS - 2))
        return [x * invlen for x in _fft_field(
            vals, list(roots_of_unity[0:1]) + list(roots_of_unity[:0:-1]))]
    else:
        # Regular FFT
        return _fft_field(vals, roots_of_unity)


def coset_fft_field(vals, roots_of_unity, inv: bool = False):
    """FFT/IFFT over a coset of the roots of unity — used to divide by a
    polynomial that vanishes inside the domain."""
    vals = [v for v in vals]  # copy

    def shift_vals(vals, factor):
        # [vals[0]*factor^0, vals[1]*factor^1, ...]
        updated_vals = []
        shift = BLSFieldElement(1)
        for i in range(len(vals)):
            updated_vals.append(vals[i] * shift)
            shift = shift * factor
        return updated_vals

    # the coset generator
    shift_factor = BLSFieldElement(PRIMITIVE_ROOT_OF_UNITY)
    if inv:
        vals = fft_field(vals, roots_of_unity, inv)
        return shift_vals(vals, shift_factor.inverse())
    else:
        vals = shift_vals(vals, shift_factor)
        return fft_field(vals, roots_of_unity, inv)


def compute_verify_cell_kzg_proof_batch_challenge(
        commitments, commitment_indices, cell_indices, cosets_evals,
        proofs) -> BLSFieldElement:
    """Fiat-Shamir challenge over everything influencing verification."""
    hashinput = RANDOM_CHALLENGE_KZG_CELL_BATCH_DOMAIN
    hashinput += int.to_bytes(FIELD_ELEMENTS_PER_BLOB, 8, KZG_ENDIANNESS)
    hashinput += int.to_bytes(FIELD_ELEMENTS_PER_CELL, 8, KZG_ENDIANNESS)
    hashinput += int.to_bytes(len(commitments), 8, KZG_ENDIANNESS)
    hashinput += int.to_bytes(len(cell_indices), 8, KZG_ENDIANNESS)
    for commitment in commitments:
        hashinput += commitment
    for k, coset_evals in enumerate(cosets_evals):
        hashinput += int.to_bytes(commitment_indices[k], 8, KZG_ENDIANNESS)
        hashinput += int.to_bytes(cell_indices[k], 8, KZG_ENDIANNESS)
        for coset_eval in coset_evals:
            hashinput += bls_field_to_bytes(coset_eval)
        hashinput += proofs[k]
    return hash_to_bls_field(hashinput)


# ---------------------------------------------------------------------------
# Polynomials in coefficient form (sampling.md :245-363)
# ---------------------------------------------------------------------------


def polynomial_eval_to_coeff(polynomial: Polynomial) -> PolynomialCoeff:
    """Interpolate an evaluation-form polynomial to coefficient form."""
    roots_of_unity = compute_roots_of_unity(FIELD_ELEMENTS_PER_BLOB)
    return PolynomialCoeff(fft_field(
        bit_reversal_permutation(polynomial), roots_of_unity, inv=True))


def add_polynomialcoeff(a: PolynomialCoeff,
                        b: PolynomialCoeff) -> PolynomialCoeff:
    """Sum of two coefficient-form polynomials."""
    a, b = (a, b) if len(a) >= len(b) else (b, a)
    length_a, length_b = len(a), len(b)
    return PolynomialCoeff([
        a[i] + (b[i] if i < length_b else BLSFieldElement(0))
        for i in range(length_a)
    ])


def multiply_polynomialcoeff(a: PolynomialCoeff,
                             b: PolynomialCoeff) -> PolynomialCoeff:
    """Product of two coefficient-form polynomials."""
    assert len(a) + len(b) <= FIELD_ELEMENTS_PER_EXT_BLOB

    r = PolynomialCoeff([BLSFieldElement(0)])
    for power, coef in enumerate(a):
        summand = PolynomialCoeff(
            [BLSFieldElement(0)] * power + [coef * x for x in b])
        r = add_polynomialcoeff(r, summand)
    return r


def divide_polynomialcoeff(a: PolynomialCoeff,
                           b: PolynomialCoeff) -> PolynomialCoeff:
    """Long polynomial division."""
    a = PolynomialCoeff(a[:])  # copy
    o = PolynomialCoeff([])
    apos = len(a) - 1
    bpos = len(b) - 1
    diff = apos - bpos
    while diff >= 0:
        quot = a[apos] / b[bpos]
        o.insert(0, quot)
        for i in range(bpos, -1, -1):
            a[diff + i] = a[diff + i] - b[i] * quot
        apos -= 1
        diff -= 1
    return o


def interpolate_polynomialcoeff(xs, ys) -> PolynomialCoeff:
    """Lagrange interpolation in coefficient form; leading coefficients
    may be zero."""
    assert len(xs) == len(ys)

    r = PolynomialCoeff([BLSFieldElement(0)])
    for i in range(len(xs)):
        summand = PolynomialCoeff([ys[i]])
        for j in range(len(ys)):
            if j != i:
                weight_adjustment = (xs[i] - xs[j]).inverse()
                summand = multiply_polynomialcoeff(
                    summand,
                    PolynomialCoeff([-weight_adjustment * xs[j],
                                     weight_adjustment]))
        r = add_polynomialcoeff(r, summand)
    return r


def vanishing_polynomialcoeff(xs) -> PolynomialCoeff:
    """The vanishing polynomial on ``xs`` (coefficient form)."""
    p = PolynomialCoeff([BLSFieldElement(1)])
    for x in xs:
        p = multiply_polynomialcoeff(
            p, PolynomialCoeff([-x, BLSFieldElement(1)]))
    return p


def evaluate_polynomialcoeff(polynomial_coeff: PolynomialCoeff,
                             z: BLSFieldElement) -> BLSFieldElement:
    """Horner evaluation at ``z``."""
    y = BLSFieldElement(0)
    for coef in polynomial_coeff[::-1]:
        y = y * z + coef
    return y


# ---------------------------------------------------------------------------
# KZG multiproofs (sampling.md :365-509)
# ---------------------------------------------------------------------------


def compute_kzg_proof_multi_impl(polynomial_coeff: PolynomialCoeff,
                                 zs: Coset):
    """Multi-evaluation proof over `k` points: commit to
    Q(X) = f(X) / Z(X) (I(X) vanishes in the monomial quotient since
    deg I < deg Z)."""
    # Evaluations at all the points
    ys = CosetEvals([evaluate_polynomialcoeff(polynomial_coeff, z)
                     for z in zs])

    # Compute Z(X)
    denominator_poly = vanishing_polynomialcoeff(zs)

    # Quotient directly in monomial form
    quotient_polynomial = divide_polynomialcoeff(polynomial_coeff,
                                                 denominator_poly)

    return KZGProof(g1_lincomb(
        KZG_SETUP_G1_MONOMIAL[:len(quotient_polynomial)],
        quotient_polynomial)), ys


def verify_cell_kzg_proof_batch_impl(commitments, commitment_indices,
                                     cell_indices, cosets_evals,
                                     proofs) -> bool:
    """The universal verification equation
    pairing(LL, LR) == pairing(RL, [1]) with
    LL = sum_k r^k proofs[k]; LR = [s^n];
    RL = RLC - RLI + RLP (sampling.md :405-509)."""
    assert (len(commitment_indices) == len(cell_indices)
            == len(cosets_evals) == len(proofs))
    assert len(commitments) == len(set(commitments))
    for commitment_index in commitment_indices:
        assert commitment_index < len(commitments)

    # Preparation
    num_cells = len(cell_indices)
    n = FIELD_ELEMENTS_PER_CELL
    num_commitments = len(commitments)

    # Challenge r and its powers
    r = compute_verify_cell_kzg_proof_batch_challenge(
        commitments, commitment_indices, cell_indices, cosets_evals, proofs)
    r_powers = compute_powers(r, num_cells)

    # LL = sum_k r^k proofs[k]
    ll = bls.bytes48_to_G1(g1_lincomb(proofs, r_powers))

    # LR = [s^n]
    lr = bls.bytes96_to_G2(KZG_SETUP_G2_MONOMIAL[n])

    # RLC = sum_i weights[i] commitments[i], where weights[i] folds the
    # r^k of every cell attached to commitment i
    weights = [BLSFieldElement(0)] * num_commitments
    for k in range(num_cells):
        i = commitment_indices[k]
        weights[i] += r_powers[k]
    rlc = bls.bytes48_to_G1(g1_lincomb(commitments, weights))

    # RLI = [sum_k r^k interpolation_poly_k(s)]
    sum_interp_polys_coeff = PolynomialCoeff([BLSFieldElement(0)] * n)
    for k in range(num_cells):
        interp_poly_coeff = interpolate_polynomialcoeff(
            coset_for_cell(cell_indices[k]), cosets_evals[k])
        interp_poly_scaled_coeff = multiply_polynomialcoeff(
            PolynomialCoeff([r_powers[k]]), interp_poly_coeff)
        sum_interp_polys_coeff = add_polynomialcoeff(
            sum_interp_polys_coeff, interp_poly_scaled_coeff)
    rli = bls.bytes48_to_G1(g1_lincomb(
        KZG_SETUP_G1_MONOMIAL[:n], sum_interp_polys_coeff))

    # RLP = sum_k (r^k * h_k^n) proofs[k]
    weighted_r_powers = []
    for k in range(num_cells):
        h_k = coset_shift_for_cell(cell_indices[k])
        h_k_pow = h_k.pow(BLSFieldElement(n))
        wrp = r_powers[k] * h_k_pow
        weighted_r_powers.append(wrp)
    rlp = bls.bytes48_to_G1(g1_lincomb(proofs, weighted_r_powers))

    # RL = RLC - RLI + RLP
    rl = bls.add(rlc, bls.neg(rli))
    rl = bls.add(rl, rlp)

    # pairing (LL, LR) == pairing (RL, [1])
    return bls.pairing_check([
        [ll, lr],
        [rl, bls.neg(bls.bytes96_to_G2(KZG_SETUP_G2_MONOMIAL[0]))],
    ])


# ---------------------------------------------------------------------------
# Cell cosets (sampling.md :511-551)
# ---------------------------------------------------------------------------


def coset_shift_for_cell(cell_index: CellIndex) -> BLSFieldElement:
    """The shift h defining cell `cell_index`'s coset h*G, where G is the
    order-FIELD_ELEMENTS_PER_CELL subgroup."""
    assert cell_index < CELLS_PER_EXT_BLOB
    roots_of_unity_brp = bit_reversal_permutation(
        compute_roots_of_unity(FIELD_ELEMENTS_PER_EXT_BLOB))
    return roots_of_unity_brp[FIELD_ELEMENTS_PER_CELL * cell_index]


def coset_for_cell(cell_index: CellIndex) -> Coset:
    """The coset h*G for cell `cell_index`."""
    assert cell_index < CELLS_PER_EXT_BLOB
    roots_of_unity_brp = bit_reversal_permutation(
        compute_roots_of_unity(FIELD_ELEMENTS_PER_EXT_BLOB))
    return Coset(roots_of_unity_brp[
        FIELD_ELEMENTS_PER_CELL * cell_index:
        FIELD_ELEMENTS_PER_CELL * (cell_index + 1)])


# ---------------------------------------------------------------------------
# Cells (sampling.md :553-668)
# ---------------------------------------------------------------------------


def compute_cells(blob: Blob):
    """Extend a blob and return all cells of the extension.
    Public method.

    The normative definition (sampling.md:560-576) evaluates the
    coefficient form at every coset point individually — O(n^2).  Every
    cell coset is a contiguous slice of the bit-reversed extended
    domain (`coset_for_cell`), so one size-2n FFT followed by the
    bit-reversal permutation produces the identical evaluations; pinned
    against the naive evaluator in
    tests/fulu/unittests/test_polynomial_commitments.py."""
    assert len(blob) == BYTES_PER_BLOB

    polynomial = blob_to_polynomial(blob)
    polynomial_coeff = polynomial_eval_to_coeff(polynomial)

    padded = list(polynomial_coeff) + [BLSFieldElement(0)] * (
        int(FIELD_ELEMENTS_PER_EXT_BLOB) - len(polynomial_coeff))
    extended = fft_field(
        padded, compute_roots_of_unity(FIELD_ELEMENTS_PER_EXT_BLOB))
    extended_brp = bit_reversal_permutation(extended)

    n = int(FIELD_ELEMENTS_PER_CELL)
    return [
        coset_evals_to_cell(CosetEvals(extended_brp[i * n:(i + 1) * n]))
        for i in range(CELLS_PER_EXT_BLOB)
    ]


def compute_cells_and_kzg_proofs_polynomialcoeff(
        polynomial_coeff: PolynomialCoeff):
    """Cells + proofs for a coefficient-form polynomial."""
    cells, proofs = [], []
    for i in range(CELLS_PER_EXT_BLOB):
        coset = coset_for_cell(CellIndex(i))
        proof, ys = compute_kzg_proof_multi_impl(polynomial_coeff, coset)
        cells.append(coset_evals_to_cell(CosetEvals(ys)))
        proofs.append(proof)
    return cells, proofs


def compute_cells_and_kzg_proofs(blob: Blob):
    """All cell proofs for an extended blob (naive O(n^2); FK20 is the
    performant path).  Public method.

    Device routing (the port's `das`): under the "torch" backend with
    real BLS active, FK20 on the facade's device computes the identical
    cells and proofs."""
    assert len(blob) == BYTES_PER_BLOB

    if bls.backend_name() == "torch" and bls.bls_active:
        from ...das import compute as _das_compute

        cells, proofs = _das_compute.compute_cells_and_kzg_proofs(
            bytes(blob))
        return ([Cell(c) for c in cells],
                [KZGProof(p) for p in proofs])

    polynomial = blob_to_polynomial(blob)
    polynomial_coeff = polynomial_eval_to_coeff(polynomial)
    return compute_cells_and_kzg_proofs_polynomialcoeff(polynomial_coeff)


def verify_cell_kzg_proof_batch(commitments_bytes, cell_indices, cells,
                                proofs_bytes) -> bool:
    """Verify (commitment, cell_index, cell, proof) tuples via the
    universal verification equation.  Public method.

    Device routing (the port's `das`): under the "torch" backend with
    real BLS active, the whole batch verifies on the facade's device
    (K17, the MSMs, K12 -> K10), accept/reject identical to the oracle
    below (malformed input raises on both routes)."""
    if bls.backend_name() == "torch" and bls.bls_active:
        from ...das import verify as _das_verify

        return _das_verify.verify_cell_proof_batch(
            commitments_bytes, cell_indices, cells, proofs_bytes)

    assert (len(commitments_bytes) == len(cells) == len(proofs_bytes)
            == len(cell_indices))
    for commitment_bytes in commitments_bytes:
        assert len(commitment_bytes) == BYTES_PER_COMMITMENT
    for cell_index in cell_indices:
        assert cell_index < CELLS_PER_EXT_BLOB
    for cell in cells:
        assert len(cell) == BYTES_PER_CELL
    for proof_bytes in proofs_bytes:
        assert len(proof_bytes) == BYTES_PER_PROOF

    # Deduplicated commitment list...
    deduplicated_commitments = [
        bytes_to_kzg_commitment(commitment_bytes)
        for commitment_bytes in set(commitments_bytes)
    ]
    # ...and the index mapping into it
    commitment_indices = [
        CommitmentIndex(deduplicated_commitments.index(commitment_bytes))
        for commitment_bytes in commitments_bytes
    ]

    cosets_evals = [cell_to_coset_evals(cell) for cell in cells]
    proofs = [bytes_to_kzg_proof(proof_bytes)
              for proof_bytes in proofs_bytes]

    return verify_cell_kzg_proof_batch_impl(
        deduplicated_commitments, commitment_indices, cell_indices,
        cosets_evals, proofs)


# ---------------------------------------------------------------------------
# Reconstruction (sampling.md :670-817)
# ---------------------------------------------------------------------------


def construct_vanishing_polynomial(missing_cell_indices):
    """Vanishing polynomial over every missing field element, built from
    the short per-cell vanishing polynomial via the closed form over a
    coset (assumes not all cells are missing)."""
    # The small domain
    roots_of_unity_reduced = compute_roots_of_unity(CELLS_PER_EXT_BLOB)

    # Vanishing polynomial over the small domain
    short_zero_poly = vanishing_polynomialcoeff([
        roots_of_unity_reduced[reverse_bits(missing_cell_index,
                                            CELLS_PER_EXT_BLOB)]
        for missing_cell_index in missing_cell_indices
    ])

    # Extend to the full domain
    zero_poly_coeff = [BLSFieldElement(0)] * FIELD_ELEMENTS_PER_EXT_BLOB
    for i, coeff in enumerate(short_zero_poly):
        zero_poly_coeff[i * FIELD_ELEMENTS_PER_CELL] = coeff

    return zero_poly_coeff


def recover_polynomialcoeff(cell_indices, cosets_evals) -> PolynomialCoeff:
    """Recover the coefficient-form polynomial whose evaluations give the
    extended blob (Reed-Solomon recovery via FFTs)."""
    # The FFT domain
    roots_of_unity_extended = compute_roots_of_unity(
        FIELD_ELEMENTS_PER_EXT_BLOB)

    # Flatten the evaluations; missing cells evaluate to zero
    extended_evaluation_rbo = ([BLSFieldElement(0)]
                               * FIELD_ELEMENTS_PER_EXT_BLOB)
    for cell_index, cell in zip(cell_indices, cosets_evals):
        start = cell_index * FIELD_ELEMENTS_PER_CELL
        end = (cell_index + 1) * FIELD_ELEMENTS_PER_CELL
        extended_evaluation_rbo[start:end] = cell
    extended_evaluation = bit_reversal_permutation(extended_evaluation_rbo)

    # Z(x): vanishes on all missing evaluations
    missing_cell_indices = [
        CellIndex(cell_index) for cell_index in range(CELLS_PER_EXT_BLOB)
        if cell_index not in cell_indices
    ]
    zero_poly_coeff = construct_vanishing_polynomial(missing_cell_indices)

    # Z(x) in evaluation form over the FFT domain
    zero_poly_eval = fft_field(zero_poly_coeff, roots_of_unity_extended)

    # (E*Z)(x) in evaluation form — agrees with (P*Z)(x) on the domain
    extended_evaluation_times_zero = [
        a * b for a, b in zip(zero_poly_eval, extended_evaluation)]

    # IFFT gives the coefficients of (P*Z)(x)
    extended_evaluation_times_zero_coeffs = fft_field(
        extended_evaluation_times_zero, roots_of_unity_extended, inv=True)

    # Divide (P*Z)(x) / Z(x) in evaluation form over a coset (no zeros)
    extended_evaluations_over_coset = coset_fft_field(
        extended_evaluation_times_zero_coeffs, roots_of_unity_extended)
    zero_poly_over_coset = coset_fft_field(zero_poly_coeff,
                                           roots_of_unity_extended)
    reconstructed_poly_over_coset = [
        a / b for a, b in zip(extended_evaluations_over_coset,
                              zero_poly_over_coset)]

    # Back to coefficient form
    reconstructed_poly_coeff = coset_fft_field(
        reconstructed_poly_over_coset, roots_of_unity_extended, inv=True)

    return PolynomialCoeff(reconstructed_poly_coeff[:FIELD_ELEMENTS_PER_BLOB])


def recover_cells_and_kzg_proofs(cell_indices, cells):
    """Given >= 50% of a blob's cells, recover all cells and proofs.
    Public method.

    Device routing (the port's `das`): under the "torch" backend with
    real BLS active, `das.recover` decodes on the facade's device and
    re-proves through FK20: byte-identical cells and proofs, the same
    AssertionError contract on malformed input."""
    if bls.backend_name() == "torch" and bls.bls_active:
        from ...das import recover as _das_recover

        out_cells, out_proofs = _das_recover.recover_cells_and_kzg_proofs(
            [int(k) for k in cell_indices], [bytes(c) for c in cells])
        return ([Cell(c) for c in out_cells],
                [KZGProof(p) for p in out_proofs])

    # Same number of cells and indices
    assert len(cell_indices) == len(cells)
    # Enough cells to reconstruct
    assert CELLS_PER_EXT_BLOB // 2 <= len(cell_indices) <= CELLS_PER_EXT_BLOB
    # No duplicates
    assert len(cell_indices) == len(set(cell_indices))
    # Indices in bounds
    for cell_index in cell_indices:
        assert cell_index < CELLS_PER_EXT_BLOB
    # Cells correctly sized
    for cell in cells:
        assert len(cell) == BYTES_PER_CELL

    # Convert cells to coset evaluations
    cosets_evals = [cell_to_coset_evals(cell) for cell in cells]

    # Recover the polynomial in coefficient form
    polynomial_coeff = recover_polynomialcoeff(cell_indices, cosets_evals)

    # Recompute all cells/proofs
    return compute_cells_and_kzg_proofs_polynomialcoeff(polynomial_coeff)
