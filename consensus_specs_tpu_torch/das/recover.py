"""Erasure recovery for PeerDAS extended blobs (counterpart of the JAX
package's `das/recover.py`, its synchronous surface).

The fulu oracle (`recover_cells_and_kzg_proofs`) rebuilds a blob
polynomial from any half or more of its 128 cells by the Reed-Solomon
decode over FFTs, then proves every cell again.  This module computes the
same bytes on two routes:

host route (`recover_cells_and_kzg_proofs_host`)
    the port's fulu module end to end (`models/fulu/
    polynomial_commitments_sampling.py`: `recover_polynomialcoeff` and
    the per-coset quotient producer).  Minutes per blob.

device route (the default, `recover_cells_and_kzg_proofs`)
    the coset-structured decode of `recover_coefficients_device`, every
    intermediate kept as Montgomery limbs on the device:

        Z(x)   = FFT(zero_poly)                      K18 forward
        (E*Z)  = IFFT(Z(x) * E(x))                   K15 mul, K18 inverse
        coset  = FFT(shift^i * ..) for E*Z and Z     K15 mul, K18 batch 2
        P(x)   = IFFT(coset quotient) / shift^i      K15 (Montgomery's
                                                     batch inverse, one
                                                     launch), K18

    with the bit reversals as device indexing; the vanishing polynomial
    is built on the host from its short order-128 product (at most 64
    monomial multiplies).  The recovered coefficients then re-evaluate
    through the forward FFT of `compute_cells` and re-prove through FK20
    (`compute._fk20_proofs_device`) without leaving the device.

`device` picks the route as `das.verify.device_for` does (None follows
the BLS facade, whose default is CUDA; False is the host route).  Both
routes reject malformed input with the oracle's AssertionError.

The `*_async` form, `DeviceFuture` and the telemetry seams are not
ported yet.
"""

from __future__ import annotations

import functools
import time

import torch

from .. import resolve_device
from . import ciphersuite as cs
from . import compute as dc
from .verify import device_for

P = cs.BLS_MODULUS
M = cs.FIELD_ELEMENTS_PER_BLOB
M_EXT = cs.FIELD_ELEMENTS_PER_EXT_BLOB
L = cs.FIELD_ELEMENTS_PER_CELL
N_EXT = cs.CELLS_PER_EXT_BLOB
_SHIFT = cs.PRIMITIVE_ROOT_OF_UNITY


def _assert_recoverable(cell_indices, cells) -> None:
    """The oracle's argument contract (AssertionError, like the
    oracle)."""
    assert len(cell_indices) == len(cells)
    assert N_EXT // 2 <= len(cell_indices) <= N_EXT
    assert len(cell_indices) == len(set(cell_indices))
    for cell_index in cell_indices:
        assert cell_index < N_EXT
    for cell in cells:
        assert len(cell) == cs.BYTES_PER_CELL


def _cell_rows(cells) -> list[list[int]]:
    return [[int.from_bytes(
        bytes(cell)[i * cs.BYTES_PER_FIELD_ELEMENT:
                    (i + 1) * cs.BYTES_PER_FIELD_ELEMENT],
        cs.KZG_ENDIANNESS) for i in range(L)] for cell in cells]


def _short_vanishing(missing_cell_indices) -> list[int]:
    """Coefficients of prod (X - w_128^rev7(k)) over the missing cells,
    the order-128 vanishing polynomial (host arithmetic)."""
    roots = cs.roots_of_unity(N_EXT)
    poly = [1]
    for k in missing_cell_indices:
        r = roots[cs.reverse_bits(int(k), N_EXT)]
        nxt = [0] * (len(poly) + 1)
        for i, c in enumerate(poly):
            nxt[i] = (nxt[i] - c * r) % P
            nxt[i + 1] = (nxt[i + 1] + c) % P
        poly = nxt
    return poly


def construct_vanishing_poly(missing_cell_indices) -> list[int]:
    """The extended-domain vanishing polynomial: the short order-128
    product embedded at stride 64 into 8192 coefficients (the oracle's
    `construct_vanishing_polynomial`, on ints)."""
    short = _short_vanishing(missing_cell_indices)
    out = [0] * M_EXT
    for i, c in enumerate(short):
        out[i * L] = c
    return out


def _batch_inverse(vals: list[int]) -> list[int]:
    """Montgomery's trick on host ints: n inversions for one modpow and
    3 (n - 1) products."""
    pref = [1] * (len(vals) + 1)
    for i, v in enumerate(vals):
        pref[i + 1] = pref[i] * v % P
    inv = pow(pref[-1], P - 2, P)
    out = [0] * len(vals)
    for i in range(len(vals) - 1, -1, -1):
        out[i] = pref[i] * inv % P
        inv = inv * vals[i] % P
    return out


def _shift_scale(vals, factor: int) -> list[int]:
    out, cur = [], 1
    for v in vals:
        out.append(v * cur % P)
        cur = cur * factor % P
    return out


# --- the decode on limbs -------------------------------------------------------


def _dense(t: torch.Tensor) -> torch.Tensor:
    """t itself if the kernels can take it as it is (contiguous, 16-byte
    aligned), else a fresh copy (a one-row slice is contiguous but may
    start mid-row)."""
    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _mul(a, b):
    from ..ops.fr_batch import field_op

    return field_op("mul", _dense(a), _dense(b))


def _batch_inverse_limbs(x: torch.Tensor) -> torch.Tensor:
    """Montgomery's trick on (n, 33) limbs: K15's batch inverse in one
    launch on the card (one binary inversion, 3 (n - 1) products), its
    plain product tree on the CPU.  A zero element makes every output
    0."""
    from ..ops.fr_batch import batch_inverse

    return batch_inverse(x)


def _limbs(ints, dev) -> torch.Tensor:
    from ..ops.fr_batch import FR

    return torch.from_numpy(FR.to_mont_batch(ints)).to(dev)


@functools.lru_cache(maxsize=4)
def _shift_tables(dev: torch.device):
    """[shift^i] over the extended domain and [shift^-i] over the blob,
    as Montgomery limbs on `dev`."""
    return (_limbs(_shift_scale([1] * M_EXT, _SHIFT), dev)[None],
            _limbs(_shift_scale([1] * M, pow(_SHIFT, P - 2, P)), dev))


def _recover_coefficient_limbs(cell_indices, rows, dev) -> torch.Tensor:
    """The decode of `recover_coefficients_device` on `dev`: the M
    coefficients as Montgomery limbs (M, 33), on the device."""
    have = {int(k) for k in cell_indices}
    missing = [k for k in range(N_EXT) if k not in have]
    zero_poly = _limbs(construct_vanishing_poly(missing), dev)[None]
    ext_rbo = [0] * M_EXT
    for k, row in zip(cell_indices, rows):
        ext_rbo[int(k) * L:(int(k) + 1) * L] = [int(v) % P for v in row]
    brp, _, _ = dc._domain_consts(M_EXT, False, dev)
    ext = _limbs(ext_rbo, dev)[brp][None]
    shift, unshift = _shift_tables(dev)
    zero_eval = dc.domain_fft(zero_poly)
    ez_coeffs = dc.domain_fft(_mul(zero_eval, ext), inverse=True)
    coset = dc.domain_fft(torch.cat([_mul(ez_coeffs, shift),
                                     _mul(zero_poly, shift)]))
    quotient = _mul(coset[0], _batch_inverse_limbs(coset[1]))
    shifted = dc.domain_fft(quotient[None], inverse=True)[0]
    return _mul(shifted[:M], unshift)


def recover_coefficients_device(cell_indices, rows, device="cuda") -> list[int]:
    """The decode: surviving cells (field-element rows in stored coset
    order) -> the 4096 blob polynomial coefficients, as ints, computed on
    `device` (the plain versions on the CPU)."""
    from ..ops.fr_batch import from_limbs

    dev = resolve_device(device)
    return from_limbs(_recover_coefficient_limbs(cell_indices, rows, dev))


# --- the routes ----------------------------------------------------------------


def recover_cells_and_kzg_proofs_host(cell_indices, cells):
    """The port's fulu module end to end (the decode, then the naive
    per-coset producer): minutes per blob."""
    from ..models.fulu import polynomial_commitments_sampling as fulu

    _assert_recoverable(cell_indices, cells)
    cosets_evals = [fulu.cell_to_coset_evals(bytes(cell)) for cell in cells]
    coeffs = fulu.recover_polynomialcoeff(
        [int(k) for k in cell_indices], cosets_evals)
    out_cells, out_proofs = \
        fulu.compute_cells_and_kzg_proofs_polynomialcoeff(coeffs)
    return [bytes(c) for c in out_cells], [bytes(p) for p in out_proofs]


def _recover_route(device):
    """The device the recovery runs on, or None for the host route."""
    return device_for(device)


def recover_cells_and_kzg_proofs(cell_indices, cells, device=None,
                                 trace=None):
    """(cells, proofs) of the whole extended blob from `cells` at
    `cell_indices` (at least half of the 128): the device route by
    default, the host route with `device=False`.  With `trace` (a dict)
    on the device route, the host-clock seconds of the decode, the
    re-evaluation and the re-prove are stored in it, the device
    synchronised after each."""
    dev = _recover_route(device)
    if dev is None:
        return recover_cells_and_kzg_proofs_host(cell_indices, cells)
    _assert_recoverable(cell_indices, cells)
    dev = resolve_device(dev)

    def lap(t0):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter() - t0

    from ..ops.fr_batch import from_limbs

    t0 = time.perf_counter()
    coeffs = _recover_coefficient_limbs([int(k) for k in cell_indices],
                                        _cell_rows(cells), dev)
    t_decode = lap(t0)
    t0 = time.perf_counter()
    padded = torch.cat([coeffs, torch.zeros_like(coeffs)])[None]
    out_cells = dc._cells_of(from_limbs(dc.domain_fft(padded)))
    t_eval = lap(t0)
    t0 = time.perf_counter()
    out_proofs = dc._fk20_proofs_device(coeffs, device=dev)
    t_prove = lap(t0)
    if trace is not None:
        trace["seconds"] = {"decode": t_decode, "evaluate": t_eval,
                            "prove": t_prove}
    return out_cells, out_proofs
