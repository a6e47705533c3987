"""Slice 5 of the port, PeerDAS: `consensus_specs_tpu_torch/das` against
the JAX package's `das` (tolerance zero).  The ciphersuite's tables and
closed-form matrices byte for byte; `parse_cell_batch`'s challenge and
weights (one process, so the dedup set's order is shared); the batch
verdicts of `verify_cell_proof_batch` on a 2-blob x 4-column matrix (8
cells, rung 16) through the device route's plain versions on the CPU
(K17, K13, K12 -> K10) and the host route, valid and with one tampered
cell, against JAX's host route; `verify_and_isolate`;
`evaluate_cells_at` (K16's plain version with the coset shift) against
the host route and JAX's; `compute_cells` (K18's plain version) of the
closed-form degree-65 blob against JAX's and the closed form.

The device route's per-cell rechecks of `verify_and_isolate` (nine
batches) and JAX's own device route are `@slow`."""

import functools

import pytest
import torch

from consensus_specs_tpu.das import ciphersuite as Jcs
from consensus_specs_tpu.das import compute as Jcompute
from consensus_specs_tpu.das import verify as Jverify
from consensus_specs_tpu.ops import bls as jbls
from consensus_specs_tpu.ops import fr_batch as Jfr
from consensus_specs_tpu_torch import convert as C
from consensus_specs_tpu_torch import das as D
from consensus_specs_tpu_torch.das import ciphersuite as Tcs
from consensus_specs_tpu_torch.das import compute as Tcompute
from consensus_specs_tpu_torch.das import verify as Tverify
from consensus_specs_tpu_torch.ops import bls as tbls


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions are thousands of small int32 ops: one intra-op
    thread runs them faster than a pool of one thread per core, and
    keeps parallel test workers from oversubscribing the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture()
def real_bls():
    prev = jbls.bls_active
    jbls.bls_active = True
    yield
    jbls.bls_active = prev


@functools.cache
def _matrix():
    """2 rows x 4 columns spanning both domain halves (JAX's
    tests/test_das.py fixture)."""
    return Tcs.closed_form_matrix(2, columns=[0, 3, 64, 127])


def _tamper_cell(cells, k):
    cells = list(cells)
    cells[k] = cells[k][:-32] + int.to_bytes(7, 32, "big")
    return cells


def test_ciphersuite_tables_match_jax():
    for order in (64, 128, 4096, 8192):
        assert Tcs.roots_of_unity(order) == Jcs.roots_of_unity(order)
    for k in (0, 1, 3, 63, 64, 127):
        assert Tcs.coset_shift(k) == Jcs.coset_shift(k)
        assert Tcs.coset_points(k) == Jcs.coset_points(k)
    assert Tcs.coset_idft_matrix() == Jcs.coset_idft_matrix()
    assert Tcs.setup_g1_monomial_bytes() == Jcs.setup_g1_monomial_bytes()
    for name in ("BLS_MODULUS", "FIELD_ELEMENTS_PER_BLOB",
                 "FIELD_ELEMENTS_PER_CELL", "CELLS_PER_EXT_BLOB",
                 "BYTES_PER_CELL", "RANDOM_CHALLENGE_KZG_CELL_BATCH_DOMAIN"):
        assert getattr(Tcs, name) == getattr(Jcs, name), name
    _, idx, cells, _ = _matrix()
    evals = Tverify.cell_evals(cells[1])
    assert Tcs.interpolate_coset_coeffs(idx[1], evals) == \
        Jcs.interpolate_coset_coeffs(idx[1], evals)


def test_closed_form_matrix_matches_jax_byte_for_byte():
    assert _matrix() == Jcs.closed_form_matrix(2, columns=[0, 3, 64, 127])
    assert Tcs.closed_form_matrix(1, columns=[5]) == Jcs.closed_form_matrix(
        1, columns=[5], seed=20250)


def test_parse_cell_batch_challenge_and_weights_match_jax():
    com, idx, cells, proofs = _matrix()
    # repeat a statement's commitment out of order: the dedup set's order
    # and the challenge are the same expression's in one process
    com, idx = [com[5]] + com[1:], list(idx)
    t = Tcs.parse_cell_batch(com, idx, cells, proofs)
    j = Jcs.parse_cell_batch(com, idx, cells, proofs)
    assert t.commitment_bytes == j.commitment_bytes
    assert t.commitment_indices == j.commitment_indices
    assert (t.n_cells, t.cell_indices, t.evals, t.proof_bytes) == \
        (j.n_cells, j.cell_indices, j.evals, j.proof_bytes)
    assert t.r == j.r and t.r_powers == j.r_powers
    assert t.weights() == j.weights()
    assert t.weighted_r_powers() == j.weighted_r_powers()
    assert t.shifts == j.shifts
    assert Tverify._rli_weight_rows(t) == Jverify._rli_weight_rows(j)
    assert Tverify._host_rli_coeffs(t) == Jverify._host_rli_coeffs(j)
    assert Tcs.compute_challenge(t.commitment_bytes, t.commitment_indices,
                                 t.cell_indices, t.evals,
                                 t.proof_bytes) == t.r


def test_parse_rejects_malformed_like_jax():
    com, idx, cells, proofs = _matrix()
    big = Tcs.BLS_MODULUS.to_bytes(32, "big")
    for m in ((com[:-1], idx, cells, proofs),
              (com, [128] + idx[1:], cells, proofs),
              (com, idx, [cells[0][:-1]] + cells[1:], proofs),
              (com, idx, cells, [b"\x01" * 48] + proofs[1:]),
              ([b"\xaa" * 48] + com[1:], idx, cells, proofs),
              (com, idx, [cells[0][:-32] + big] + cells[1:], proofs)):
        for parse in (Tcs.parse_cell_batch, Jcs.parse_cell_batch):
            with pytest.raises(AssertionError):
                parse(*m)


def test_device_route_verdicts_match_jax_host_route(real_bls):
    """The 8-cell batch (rung 16) through the device route's plain
    versions on the CPU, valid and with one tampered cell; the RLI
    coefficients equal JAX's fold."""
    com, idx, cells, proofs = _matrix()
    trace = {}
    assert Tverify.verify_cell_proof_batch_device(
        com, idx, cells, proofs, device="cpu", trace=trace) is True
    batch = trace["batch"]
    assert trace["rli"] == Jfr.coset_interpolate_sum(
        batch.evals, Jcs.coset_idft_matrix(),
        Jverify._rli_weight_rows(batch))
    assert set(trace["seconds"]) == {"parse", "rli", "msm", "pairing"}
    assert Jverify.verify_cell_proof_batch_host(com, idx, cells, proofs)
    bad = _tamper_cell(cells, 2)
    assert D.verify_cell_proof_batch(com, idx, bad, proofs,
                                     device="cpu") is False
    assert Jverify.verify_cell_proof_batch_host(com, idx, bad,
                                                proofs) is False


def test_host_route_and_isolation_match_jax(real_bls):
    com, idx, cells, proofs = _matrix()
    assert D.verify_cell_proof_batch_host(com, idx, cells, proofs) is True
    assert D.verify_cell_proof_batch(com, idx, cells, proofs,
                                     device=False) is True
    bad_proofs = list(proofs)
    bad_proofs[0] = proofs[4]
    assert D.verify_cell_proof_batch_host(com, idx, cells,
                                          bad_proofs) is False
    assert D.verify_cell_proof_batch_host([], [], [], []) is True
    bad = _tamper_cell(cells, 5)
    want = Jverify.verify_and_isolate(com, idx, bad, proofs, device=False)
    assert want == (False, [k != 5 for k in range(8)])
    assert D.verify_and_isolate(com, idx, bad, proofs, device=False) == want
    assert D.verify_and_isolate(com, idx, cells, proofs, device=False) == \
        (True, [True] * 8)


def test_device_route_follows_the_facade(monkeypatch):
    monkeypatch.setattr(tbls, "_device", "cpu")
    assert Tverify.device_for(None) == "cpu"
    assert Tverify.device_for(True) == "cuda"
    assert Tverify.device_for(False) is None
    assert Tverify.device_for("cpu") == "cpu"
    monkeypatch.setattr(tbls, "_backend_name", "py")
    assert Tverify.device_for(None) is None


def test_evaluate_cells_at_matches_the_host_route_and_jax():
    _, idx, cells, _ = _matrix()
    z = 0xFEEDFACE
    got = D.evaluate_cells_at(cells[:3], idx[:3], z, device="cpu")
    assert got == D.evaluate_cells_at(cells[:3], idx[:3], z, device=False)
    assert got == Jverify.evaluate_cells_at(cells[:3], idx[:3], z,
                                            device=False)
    assert got == Jverify.evaluate_cells_at(cells[:3], idx[:3], z,
                                            device=True)
    point = Tcs.coset_points(idx[0])[5]
    for device in ("cpu", False):
        assert D.evaluate_cells_at([cells[0]], [idx[0]], point,
                                   device=device) == \
            [Tverify.cell_evals(cells[0])[5]]


def test_compute_cells_of_the_closed_form_blob():
    blob, cells, proofs, commitment = C.closed_form_blob()
    got = D.compute_cells(blob, device="cpu")
    assert got == cells
    assert got == Jcompute.compute_cells(blob, device=False)
    assert Tcompute.compute_cells(blob, device=False) == cells
    assert Tcompute.poly_coefficients(blob, device=False) == \
        Jcompute.poly_coefficients(blob, device=False)
    # the closed form's row, as JAX's ciphersuite writes it
    com, per_cell = Jcs.closed_form_row(90001, 80001, 70001, [0, 127])
    assert com == commitment
    assert [per_cell[k] for k in (0, 127)] == [(cells[0], proofs[0]),
                                               (cells[127], proofs[127])]


@pytest.mark.slow
def test_device_route_isolation_and_jax_device_route(real_bls):
    """verify_and_isolate through the device route's plain versions (the
    batch and eight per-cell rechecks), and the same verdicts from JAX's
    device route."""
    com, idx, cells, proofs = _matrix()
    bad = _tamper_cell(cells, 6)
    want = (False, [k != 6 for k in range(8)])
    assert D.verify_and_isolate(com, idx, bad, proofs, device="cpu") == want
    assert Jverify.verify_and_isolate(com, idx, bad, proofs,
                                      device=True) == want
    assert Jverify.verify_cell_proof_batch(com, idx, cells, proofs,
                                           device=True) is True
