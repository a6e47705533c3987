"""Cell computation for the DAS workload (counterpart of the JAX
package's `das/compute.py:51-137`, the cells only).

`compute_cells` extends a blob to its 128 cells with one inverse FFT
at n = 4096 (the coefficient form, `poly_coefficients`) and one forward
FFT at n = 8192 (the extension over the whole bit-reversed extended
domain), bit-exact against the spec's `compute_cells`.  On the device
route each transform is one `ops.fr_batch.fr_fft` (K18); the host route
is the recursive `_fft`, the oracle's shape.  `device` follows
`das.verify.device_for`.

The proofs (FK20, the residue-grouped quotients) come with the G1 FFT
in a later slice.
"""

from __future__ import annotations

from . import ciphersuite as cs
from .verify import device_for

M = cs.FIELD_ELEMENTS_PER_BLOB
L = cs.FIELD_ELEMENTS_PER_CELL
P = cs.BLS_MODULUS


# --- field FFTs (host ints, the oracle's recursive shape) -------------------


def _fft(vals, roots):
    if len(vals) == 1:
        return vals
    left = _fft(vals[::2], roots[::2])
    right = _fft(vals[1::2], roots[::2])
    out = [0] * len(vals)
    half = len(left)
    for i, (x, y) in enumerate(zip(left, right)):
        yr = y * roots[i] % P
        out[i] = (x + yr) % P
        out[i + half] = (x - yr) % P
    return out


def _ifft(vals, roots):
    inv_len = pow(len(vals), P - 2, P)
    rev = [roots[0]] + list(roots[:0:-1])
    return [v * inv_len % P for v in _fft(vals, rev)]


def blob_to_poly_ints(blob: bytes) -> list[int]:
    """The blob's evaluation form as validated ints (`blob_to
    _polynomial`)."""
    blob = bytes(blob)
    assert len(blob) == M * cs.BYTES_PER_FIELD_ELEMENT
    out = []
    for i in range(M):
        v = int.from_bytes(blob[i * 32:(i + 1) * 32], cs.KZG_ENDIANNESS)
        assert v < P
        out.append(v)
    return out


def poly_coefficients(blob: bytes, device=None) -> list[int]:
    """Coefficient form of the blob polynomial
    (`polynomial_eval_to_coeff`: un-brp, inverse FFT): one
    `ops.fr_batch.fr_fft` on the device route."""
    evals = blob_to_poly_ints(blob)
    brp = [evals[cs.reverse_bits(i, M)] for i in range(M)]
    roots = list(cs.roots_of_unity(M))
    dev = device_for(device)
    if dev is not None:
        from ..ops.fr_batch import fr_fft

        return fr_fft([brp], roots, inverse=True, device=dev)[0]
    return _ifft(brp, roots)


def _extended_evals(coeffs, device=None) -> list[int]:
    """The extension: the blob polynomial evaluated over the whole
    size-8192 domain (natural order)."""
    padded = list(coeffs) + [0] * M
    roots = list(cs.roots_of_unity(2 * M))
    dev = device_for(device)
    if dev is not None:
        from ..ops.fr_batch import fr_fft

        return fr_fft([padded], roots, device=dev)[0]
    return _fft(padded, roots)


def compute_cells(blob: bytes, device=None) -> list[bytes]:
    """All 128 cells of the extended blob via one size-8192 FFT —
    bit-exact against the spec's `compute_cells`."""
    coeffs = poly_coefficients(blob, device=device)
    ext = _extended_evals(coeffs, device=device)
    ext_brp = [ext[cs.reverse_bits(i, 2 * M)] for i in range(2 * M)]
    return [cs._encode_evals(ext_brp[k * L:(k + 1) * L])
            for k in range(cs.CELLS_PER_EXT_BLOB)]
