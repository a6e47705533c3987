"""Slice 6 of the port, the PeerDAS producer, recovery and sampling
(`consensus_specs_tpu_torch/das/compute.py`, `recover.py`, `sampling.py`
and `models/fulu/polynomial_commitments_sampling.py`) against the JAX
package (tolerance zero): the quotient scalars and the recovery helpers;
`cell_proof_for_column` and the host D_u route on the closed-form
degree-65 blob (3 nonzero coefficients, so every MSM is short) against
`closed_form_row`; the decode `recover_coefficients_device` on the CPU
(the plain versions of K18 and K15) at full width from the 64 even cells
against JAX's and the closed form; the argument contract of recovery;
the sampling functions and the port's fulu module against JAX's and the
JAX-built fulu spec on cheap inputs.  The FK20 chain is held in
`tests/test_torch_fk20.py`."""

import functools
import random
from hashlib import sha256

import pytest
import torch

from consensus_specs_tpu.das import compute as Jcompute
from consensus_specs_tpu.das import recover as Jrecover
from consensus_specs_tpu.das import sampling as Jsampling
from consensus_specs_tpu.models.builder import build_spec
from consensus_specs_tpu_torch import convert as C
from consensus_specs_tpu_torch import das as D
from consensus_specs_tpu_torch.das import ciphersuite as Tcs
from consensus_specs_tpu_torch.das import compute as Tcompute
from consensus_specs_tpu_torch.das import recover as Trecover
from consensus_specs_tpu_torch.das import sampling as Tsampling
from consensus_specs_tpu_torch.models.fulu import \
    polynomial_commitments_sampling as Tfulu
from consensus_specs_tpu_torch.ops import bls as tbls
from consensus_specs_tpu_torch.ops import fr_batch as FB

P = Tcs.BLS_MODULUS
C2, C1, C0 = 90001, 80001, 70001


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
def fulu():
    return build_spec("fulu", "mainnet")


@functools.cache
def _closed_form():
    """(blob, cells, proofs) of f = C2 X^65 + C1 X^64 + C0."""
    blob, cells, proofs, _ = C.closed_form_blob(C2, C1, C0)
    return blob, cells, proofs


def _closed_form_coeffs():
    coeffs = [0] * Tcs.FIELD_ELEMENTS_PER_BLOB
    coeffs[0], coeffs[64], coeffs[65] = C0, C1, C2
    return coeffs


def test_a_k_and_quotient_scalars_match_jax():
    for k in (0, 1, 64, 77, 127):
        assert Tcompute._a_k(k) == Jcompute._a_k(k)
    rng = random.Random(3)
    dense = [rng.randrange(P) for _ in range(Tcs.FIELD_ELEMENTS_PER_BLOB)]
    for coeffs in (_closed_form_coeffs(), dense):
        for k in (0, 77):
            a = Tcompute._a_k(k)
            assert Tcompute._quotient_scalars(coeffs, a) == \
                Jcompute._quotient_scalars(coeffs, a)


def test_recover_helpers_match_jax():
    for missing in ([1, 7, 127], list(range(1, 128, 2)), []):
        assert Trecover._short_vanishing(missing) == \
            Jrecover._short_vanishing(missing)
        assert Trecover.construct_vanishing_poly(missing) == \
            Jrecover.construct_vanishing_poly(missing)
    vals = [3, 5, 0xDEADBEEF, P - 2, 1]
    assert Trecover._batch_inverse(vals) == Jrecover._batch_inverse(vals)
    assert Trecover._shift_scale(vals, 7) == Jrecover._shift_scale(vals, 7)
    _, cells, _ = _closed_form()
    assert Trecover._cell_rows(cells[:3]) == Jrecover._cell_rows(cells[:3])


def test_batch_inverse_on_limbs_equals_host_batch_inverse():
    rng = random.Random(9)
    vals = [rng.randrange(1, P) for _ in range(16)]
    limbs = torch.from_numpy(FB.FR.to_mont_batch(vals))
    got = FB.from_limbs(Trecover._batch_inverse_limbs(limbs))
    assert got == Jrecover._batch_inverse(vals)


def test_cell_proof_for_column_matches_closed_form():
    blob, _, proofs = _closed_form()
    for k in (0, 77):
        assert Tcompute.cell_proof_for_column(blob, k, device="cpu") == \
            proofs[k]
    assert Tcompute.cell_proof_for_column(blob, 127, device=False) == \
        proofs[127]


def test_du_route_on_the_host_matches_closed_form():
    blob, cells, proofs = _closed_form()
    got_cells, got_proofs = Tcompute.compute_cells_and_kzg_proofs(
        blob, device=False)
    assert got_cells == cells
    assert got_proofs == proofs


def test_recover_decode_matches_jax_and_closed_form():
    """The decode at full width from the 64 even cells (the worst
    recoverable case): two extended-domain FFT round trips on the CPU."""
    _, cells, _ = _closed_form()
    keep = list(range(0, 128, 2))
    rows = Trecover._cell_rows([cells[k] for k in keep])
    got = Trecover.recover_coefficients_device(keep, rows, device="cpu")
    assert got == _closed_form_coeffs()
    assert got == Jrecover.recover_coefficients_device(keep, rows)


def test_recover_rejects_what_jax_rejects():
    cell = b"\x00" * Tcs.BYTES_PER_CELL
    bad_inputs = [
        (list(range(63)), [cell] * 63),                 # below half
        ([0, 0] + list(range(2, 64)), [cell] * 64),     # duplicate index
        ([128] + list(range(1, 64)), [cell] * 64),      # out of range
        (list(range(64)), [cell] * 63),                 # length mismatch
        (list(range(64)), [cell] * 63 + [cell[:-1]]),   # short cell
    ]
    for idx, cls in bad_inputs:
        with pytest.raises(AssertionError):
            Jrecover._assert_recoverable(idx, cls)
        with pytest.raises(AssertionError):
            Trecover._assert_recoverable(idx, cls)
        with pytest.raises(AssertionError):
            D.recover_cells_and_kzg_proofs(idx, cls, device="cpu")
    Trecover._assert_recoverable(list(range(64)), [cell] * 64)


# --- sampling ---------------------------------------------------------------


def _branch(leaf: bytes, index: int, depth: int):
    """A valid SSZ branch of `depth` random siblings and its root."""
    rng = random.Random(index)
    branch = [rng.randbytes(32) for _ in range(depth)]
    value = leaf
    for i, sib in enumerate(branch):
        value = (sha256(sib + value) if (index >> i) & 1
                 else sha256(value + sib)).digest()
    return branch, value


def test_inclusion_and_sample_cutting_match_jax():
    leaf = sha256(b"commitments").digest()
    branch, root = _branch(leaf, 0b1011, 6)
    for idx, rt in ((0b1011, root), (0b1010, root), (0b1011, b"\x00" * 32)):
        t = Tsampling.InclusionProof(leaf, branch, idx, rt)
        j = Jsampling.InclusionProof(leaf, branch, idx, rt)
        assert Tsampling.verify_inclusion(t) == Jsampling.verify_inclusion(j)
    assert Tsampling.verify_inclusion(
        Tsampling.InclusionProof(leaf, branch, 0b1011, root))
    matrix = Tcs.closed_form_matrix(2, columns=[5, 9])
    for col in (5, 9, 100):
        t = Tsampling.sample_from_matrix(*matrix, col)
        j = Jsampling.sample_from_matrix(*matrix, col)
        assert (t.column_index, t.commitments, t.cells, t.proofs) == \
            (j.column_index, j.commitments, j.cells, j.proofs)


def test_sample_verdicts_match_jax_host_route():
    matrix = Tcs.closed_form_matrix(2, columns=[5])
    good = Tsampling.sample_from_matrix(*matrix, 5)
    leaf = sha256(b"commitments").digest()
    branch, root = _branch(leaf, 3, 4)
    bad_branch = Tsampling.DasSample(
        5, good.commitments, good.cells, good.proofs,
        Tsampling.InclusionProof(leaf, branch, 3, b"\x01" * 32))
    structural = [
        Tsampling.DasSample(5, good.commitments, good.cells[:1],
                            good.proofs),
        Tsampling.DasSample(128, good.commitments, good.cells,
                            good.proofs),
        Tsampling.DasSample(5, [], [], []),
        bad_branch,
    ]
    for s in structural:
        j = Jsampling.DasSample(s.column_index, s.commitments, s.cells,
                                s.proofs, s.inclusion and
                                Jsampling.InclusionProof(
                                    s.inclusion.leaf, s.inclusion.branch,
                                    s.inclusion.index, s.inclusion.root))
        assert Tsampling._host_precheck(s) is False
        assert Jsampling._host_precheck(j) is False
        assert Tsampling.verify_sample(s) is False
    assert Tsampling._host_precheck(good) is None
    tampered = Tsampling.DasSample(
        5, good.commitments,
        [good.cells[0], good.cells[1][:-32] + int.to_bytes(7, 32, "big")],
        good.proofs)
    for s, want in ((good, True), (tampered, False)):
        j = Jsampling.DasSample(s.column_index, s.commitments, s.cells,
                                s.proofs)
        assert Tsampling.verify_sample_host(s) is want
        assert Jsampling.verify_sample_host(j) is want


# --- the port's fulu module ----------------------------------------------------


def test_fulu_module_matches_the_jax_spec(fulu):
    for name in ("FIELD_ELEMENTS_PER_EXT_BLOB", "FIELD_ELEMENTS_PER_CELL",
                 "BYTES_PER_CELL", "CELLS_PER_EXT_BLOB",
                 "RANDOM_CHALLENGE_KZG_CELL_BATCH_DOMAIN"):
        assert getattr(Tfulu, name) == getattr(fulu, name), name
    for k in (0, 1, 64, 127):
        assert int(Tfulu.coset_shift_for_cell(k)) == \
            int(fulu.coset_shift_for_cell(fulu.CellIndex(k)))
        assert [int(x) for x in Tfulu.coset_for_cell(k)] == \
            [int(x) for x in fulu.coset_for_cell(fulu.CellIndex(k))]
    _, cells, _ = _closed_form()
    evals = Tfulu.cell_to_coset_evals(cells[3])
    assert [int(x) for x in evals] == \
        [int(x) for x in fulu.cell_to_coset_evals(cells[3])]
    assert bytes(Tfulu.coset_evals_to_cell(evals)) == cells[3]
    roots_t = Tfulu.compute_roots_of_unity(8)
    roots_j = fulu.compute_roots_of_unity(8)
    vals = [3, 1, 4, 1, 5, 9, 2, 6]
    for inv in (False, True):
        want = [int(x) for x in fulu.fft_field(
            [fulu.BLSFieldElement(v) for v in vals], roots_j, inv=inv)]
        assert [int(x) for x in Tfulu.fft_field(
            [Tfulu.BLSFieldElement(v) for v in vals], roots_t, inv=inv)] \
            == want
        want = [int(x) for x in fulu.coset_fft_field(
            [fulu.BLSFieldElement(v) for v in vals], roots_j, inv=inv)]
        assert [int(x) for x in Tfulu.coset_fft_field(
            [Tfulu.BLSFieldElement(v) for v in vals], roots_t, inv=inv)] \
            == want
    a = [Tfulu.BLSFieldElement(v) for v in (5, 0, 7, 1)]
    b = [Tfulu.BLSFieldElement(v) for v in (2, 3)]
    ja = [fulu.BLSFieldElement(v) for v in (5, 0, 7, 1)]
    jb = [fulu.BLSFieldElement(v) for v in (2, 3)]
    ints = lambda p: [int(x) for x in p]  # noqa: E731
    assert ints(Tfulu.add_polynomialcoeff(a, b)) == \
        ints(fulu.add_polynomialcoeff(ja, jb))
    prod = Tfulu.multiply_polynomialcoeff(a, b)
    assert ints(prod) == ints(fulu.multiply_polynomialcoeff(ja, jb))
    assert ints(Tfulu.divide_polynomialcoeff(prod, b)) == ints(a)
    xs, ys = [1, 2, 3], [4, 9, 16]
    assert ints(Tfulu.interpolate_polynomialcoeff(
        [Tfulu.BLSFieldElement(x) for x in xs],
        [Tfulu.BLSFieldElement(y) for y in ys])) == \
        ints(fulu.interpolate_polynomialcoeff(
            [fulu.BLSFieldElement(x) for x in xs],
            [fulu.BLSFieldElement(y) for y in ys]))
    assert ints(Tfulu.vanishing_polynomialcoeff(
        [Tfulu.BLSFieldElement(x) for x in xs])) == \
        ints(fulu.vanishing_polynomialcoeff(
            [fulu.BLSFieldElement(x) for x in xs]))
    assert int(Tfulu.evaluate_polynomialcoeff(a, Tfulu.BLSFieldElement(11))) \
        == int(fulu.evaluate_polynomialcoeff(ja, fulu.BLSFieldElement(11)))
    missing = [1, 7, 127]
    assert ints(Tfulu.construct_vanishing_polynomial(missing)) == \
        ints(fulu.construct_vanishing_polynomial(
            [fulu.CellIndex(k) for k in missing]))
    assert ints(Tfulu.construct_vanishing_polynomial(missing)) == \
        Trecover.construct_vanishing_poly(missing)


def test_fulu_multiproof_matches_the_jax_spec_and_closed_form(fulu):
    """`compute_kzg_proof_multi_impl` of the degree-65 closed form (its
    quotient by a coset's vanishing polynomial has two coefficients)."""
    coeffs = _closed_form_coeffs()[:66]
    _, cells, proofs = _closed_form()
    for k in (0, 77):
        proof, ys = Tfulu.compute_kzg_proof_multi_impl(
            Tfulu.PolynomialCoeff([Tfulu.BLSFieldElement(c)
                                   for c in coeffs]),
            Tfulu.coset_for_cell(k))
        jproof, jys = fulu.compute_kzg_proof_multi_impl(
            fulu.PolynomialCoeff([fulu.BLSFieldElement(c) for c in coeffs]),
            fulu.coset_for_cell(fulu.CellIndex(k)))
        assert bytes(proof) == bytes(jproof) == proofs[k]
        assert [int(y) for y in ys] == [int(y) for y in jys]
        assert bytes(Tfulu.coset_evals_to_cell(Tfulu.CosetEvals(ys))) == \
            cells[k]


def test_fulu_module_routes_to_the_ports_das_under_torch(monkeypatch):
    calls = []

    def spy(name, value):
        def f(*args, **kw):
            calls.append(name)
            return value
        return f

    from consensus_specs_tpu_torch.das import compute as dc
    from consensus_specs_tpu_torch.das import recover as dr
    from consensus_specs_tpu_torch.das import verify as dv

    _, cells, proofs = _closed_form()
    monkeypatch.setattr(dc, "compute_cells_and_kzg_proofs",
                        spy("compute", (cells, proofs)))
    monkeypatch.setattr(dv, "verify_cell_proof_batch", spy("verify", True))
    monkeypatch.setattr(dr, "recover_cells_and_kzg_proofs",
                        spy("recover", (cells, proofs)))
    monkeypatch.setattr(tbls, "_backend_name", "torch")
    blob, _, _ = _closed_form()
    got = Tfulu.compute_cells_and_kzg_proofs(Tfulu.Blob(blob))
    assert [bytes(c) for c in got[0]] == cells
    assert [bytes(p) for p in got[1]] == proofs
    assert Tfulu.verify_cell_kzg_proof_batch([], [], [], []) is True
    got = Tfulu.recover_cells_and_kzg_proofs(list(range(64)), cells[:64])
    assert [bytes(p) for p in got[1]] == proofs
    assert calls == ["compute", "verify", "recover"]
