"""Batched PeerDAS cell-proof verification (counterpart of the JAX
package's `das/verify.py`, its synchronous surface).

The fulu oracle (`verify_cell_kzg_proof_batch_impl`) checks K cell
statements with ONE pairing equation

    e(LL, [s^n]) == e(RL, [1]),      n = FIELD_ELEMENTS_PER_CELL
    LL = sum_k r^k W_k
    RL = RLC - RLI + RLP
       = sum_i w_i C_i - [sum_k r^k I_k(s)] + sum_k r^k h_k^n W_k

(r the Fiat-Shamir challenge, W_k the proofs, C_i the deduplicated
commitments with folded weights w_i, I_k the degree-<64 interpolant of
cell k's evaluations over its coset h_k G).  This module computes the
same group elements from the same parsed statement
(`ciphersuite.parse_cell_batch`) on two routes:

host route (`verify_cell_proof_batch_host`)
    pure-Python Pippenger MSMs and the oracle pairing, with the
    coset-IDFT interpolation (`ciphersuite.interpolate_coset_coeffs`).

device route (the default, `verify_cell_proof_batch`)
    JAX's `_verify_device_async` stages, run in order: the RLI
    coefficient fold in one `ops.fr_batch.coset_interpolate_sum` (K17;
    the evaluations stay in stored bit-reversed coset order), the LL and
    RLP MSMs over the proofs and the RLC - RLI MSM
    (`ops.bls_batch.g1_multi_exp_device`: K14 above 512 lanes, K13
    up to it), then one `pairing_check_device` (K12 -> K10).  Cell
    batches ride the `das_rung` ladder (16 / 128 / 1024).

`device` picks the route, as the BLS facade's `DeferredBatch.verify`
does: None follows the facade's backend ("torch": the device route on
its device, CUDA; "py": the host route), True is CUDA, False the host
route, and a torch device or its name runs the device route there
("cpu": the plain versions).

`evaluate_cells_at` evaluates each cell's interpolant at a point through
`ops.fr_batch.barycentric_eval` with the coset shift (K16), or by Horner
on the host.

`n_devices`, `device_ids` or `devices` (a mesh, as
`ops.bls_batch.g1_multi_exp_sharded` takes it) send the device route's
three MSMs through the sharded MSM (K13 per shard, K27), as JAX routes
them; the rest of the route, and MSMs of an implicit request that
degrades to one card, stay on `device`.

The `*_async` forms, `DeviceFuture` and the telemetry seams are not
ported yet.
"""

from __future__ import annotations

import time

from ..ops import bls
from ..ops.bls import ciphersuite as _bls_cs
from ..ops.bls import curve as _curve
from ..ops.fr_batch import das_rung  # noqa: F401 - the cell-batch ladder
from . import ciphersuite as cs

N_CELL = cs.FIELD_ELEMENTS_PER_CELL


def device_for(device):
    """The device a `device` argument runs on, or None for the host
    route: None follows the BLS facade (its backend and device), True is
    CUDA, False the host, anything else a torch device or its name."""
    if device is None:
        return bls._device if bls.backend_name() == "torch" else None
    if device is True:
        return "cuda"
    if device is False:
        return None
    return device


def _neg_g2_gen():
    return _curve.g2.neg(cs.setup_g2_point(0))


def _rli_weight_rows(batch: cs.CellBatch) -> list[list[int]]:
    """weights[k][j] = r^k * h_k^-j — the per-(cell, coefficient)
    factors folding the IDFT outputs into RLI's scalar vector."""
    rows = []
    for rp, h in zip(batch.r_powers, batch.shifts):
        h_inv = pow(h, cs.BLS_MODULUS - 2, cs.BLS_MODULUS)
        row, cur = [], rp
        for _ in range(N_CELL):
            row.append(cur)
            cur = cur * h_inv % cs.BLS_MODULUS
        rows.append(row)
    return rows


def _rl_terms(batch: cs.CellBatch, rli_coeffs) -> tuple[list, list]:
    """(points, scalars) of the RLC - RLI part of RL as one MSM: the
    deduplicated commitments with their folded weights, plus the first
    64 monomial setup points with the NEGATED summed interpolation
    coefficients."""
    points = list(batch.commitments) + [cs.setup_g1_point(j)
                                        for j in range(N_CELL)]
    scalars = batch.weights() + [(-int(c)) % cs.BLS_MODULUS
                                 for c in rli_coeffs]
    return points, scalars


# --- host route --------------------------------------------------------------


def _host_rli_coeffs(batch: cs.CellBatch) -> list[int]:
    coeffs = [0] * N_CELL
    for k in range(batch.n_cells):
        rp = batch.r_powers[k]
        ck = cs.interpolate_coset_coeffs(batch.cell_indices[k],
                                         batch.evals[k])
        for j in range(N_CELL):
            coeffs[j] = (coeffs[j] + rp * ck[j]) % cs.BLS_MODULUS
    return coeffs


def verify_cell_proof_batch_host(commitments_bytes, cell_indices, cells,
                                 proofs_bytes) -> bool:
    """The pure-host verifier.  Same accept/reject verdict as the device
    route and the fulu spec oracle."""
    batch = cs.parse_cell_batch(commitments_bytes, cell_indices, cells,
                                proofs_bytes)
    if batch.n_cells == 0:
        return True
    rli = _host_rli_coeffs(batch)
    ll = _curve.g1.msm(batch.proofs, batch.r_powers)
    pts, sc = _rl_terms(batch, rli)
    rl = _curve.g1.add(
        _curve.g1.msm(pts, sc),
        _curve.g1.msm(batch.proofs, batch.weighted_r_powers()))
    return _bls_cs._pairing_check(
        [(ll, cs.setup_g2_point(N_CELL)), (rl, _neg_g2_gen())])


# --- device route ------------------------------------------------------------


def verify_cell_proof_batch_device(commitments_bytes, cell_indices, cells,
                                   proofs_bytes, device="cuda", trace=None,
                                   n_devices=None, device_ids=None,
                                   devices=None) -> bool:
    """The device route on `device` (JAX `_verify_device_async`'s stages
    in order), the MSMs sharded where `n_devices`, `device_ids` or
    `devices` is given.  With `trace` (a dict), the parsed batch, the RLI
    coefficients, the three MSM results and each stage's host-clock
    seconds ("parse", "rli", "msm", "pairing") are stored in it."""
    from ..ops.bls_batch import (g1_multi_exp_device, g1_multi_exp_sharded,
                                 pairing_check_device)
    from ..ops.fr_batch import coset_interpolate_sum

    if (n_devices, device_ids, devices) != (None, None, None):
        def msm(points, scalars):
            return g1_multi_exp_sharded(points, scalars, n_devices=n_devices,
                                        device_ids=device_ids,
                                        devices=devices, device=device)
    else:
        def msm(points, scalars):
            return g1_multi_exp_device(points, scalars, device=device)

    t0 = time.perf_counter()
    batch = cs.parse_cell_batch(commitments_bytes, cell_indices, cells,
                                proofs_bytes)
    if batch.n_cells == 0:
        return True
    t1 = time.perf_counter()
    rli = coset_interpolate_sum(batch.evals, cs.coset_idft_matrix(),
                                _rli_weight_rows(batch), device=device)
    t2 = time.perf_counter()
    # LL and RLP share the proof points; RLC - RLI is one small MSM
    ll = msm(batch.proofs, batch.r_powers)
    rlp = msm(batch.proofs, batch.weighted_r_powers())
    pts, sc = _rl_terms(batch, rli)
    rl_small = msm(pts, sc)
    rl = _curve.g1.add(rl_small, rlp)
    t3 = time.perf_counter()
    ok = pairing_check_device([(ll, cs.setup_g2_point(N_CELL)),
                               (rl, _neg_g2_gen())], device=device)
    t4 = time.perf_counter()
    if trace is not None:
        trace.update(batch=batch, rli=rli, ll=ll, rlp=rlp, rl_small=rl_small,
                     seconds={"parse": t1 - t0, "rli": t2 - t1,
                              "msm": t3 - t2, "pairing": t4 - t3})
    return bool(ok)


def verify_cell_proof_batch(commitments_bytes, cell_indices, cells,
                            proofs_bytes, device=None, trace=None,
                            n_devices=None, device_ids=None,
                            devices=None) -> bool:
    """The batch verdict of K cell statements (the fulu
    `verify_cell_kzg_proof_batch`): the device route by default, the host
    route with `device=False` (see the module docstring).  `trace` and
    the mesh arguments (`n_devices`, `device_ids`, `devices`: the sharded
    MSMs) go to the device route."""
    dev = device_for(device)
    if dev is None:
        return verify_cell_proof_batch_host(commitments_bytes, cell_indices,
                                            cells, proofs_bytes)
    return verify_cell_proof_batch_device(
        commitments_bytes, cell_indices, cells, proofs_bytes, device=dev,
        trace=trace, n_devices=n_devices, device_ids=device_ids,
        devices=devices)


def verify_and_isolate(commitments_bytes, cell_indices, cells,
                       proofs_bytes, device=None) -> tuple[bool, list]:
    """(batch_verdict, per_statement_verdicts): one RLC batch check,
    and — only when the batch fails — a per-statement recheck so each
    bad cell is isolated instead of poisoning the whole sample."""
    ok = verify_cell_proof_batch(commitments_bytes, cell_indices, cells,
                                 proofs_bytes, device=device)
    if ok:
        return True, [True] * len(cell_indices)
    return False, [verify_cell_proof_batch(
        [commitments_bytes[k]], [cell_indices[k]], [cells[k]],
        [proofs_bytes[k]], device=device)
        for k in range(len(cell_indices))]


# --- coset evaluation ----------------------------------------------------------


def cell_evals(cell) -> list[int]:
    """A cell's 64 field elements (stored coset order)."""
    cell = bytes(cell)
    assert len(cell) == cs.BYTES_PER_CELL
    return [int.from_bytes(
        cell[i * cs.BYTES_PER_FIELD_ELEMENT:
             (i + 1) * cs.BYTES_PER_FIELD_ELEMENT],
        cs.KZG_ENDIANNESS) for i in range(N_CELL)]


def evaluate_cells_at(cells, cell_indices, z_int, device=None) -> list[int]:
    """I_k(z) for each cell — the degree-<64 interpolant of the cell's
    evaluations over its coset, at an arbitrary field point.

    Device route: `ops.fr_batch.barycentric_eval` over the coset domain in
    stored order with `shift_int=h_k` (K16).  Host route: Horner on
    `interpolate_coset_coeffs`.  A z inside the cell's coset returns the
    stored evaluation on both routes (the barycentric denominators
    vanish there), as the oracle's `evaluate_polynomial_in_evaluation
    _form` does."""
    dev = device_for(device)
    rows = [cell_evals(cell) for cell in cells]
    z = int(z_int) % cs.BLS_MODULUS
    out = []
    for row, k in zip(rows, cell_indices):
        points = cs.coset_points(int(k))
        if z in points:
            out.append(row[points.index(z)])
        elif dev is not None:
            from ..ops.fr_batch import barycentric_eval

            out.append(barycentric_eval(row, points, z,
                                        shift_int=cs.coset_shift(int(k)),
                                        device=dev))
        else:
            acc = 0
            for c in reversed(cs.interpolate_coset_coeffs(int(k), row)):
                acc = (acc * z + c) % cs.BLS_MODULUS
            out.append(acc)
    return out
