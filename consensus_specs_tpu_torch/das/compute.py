"""Cell and proof computation for the DAS workload, the producer side
(counterpart of the JAX package's `das/compute.py`).

`compute_cells` extends a blob to its 128 cells with one inverse FFT
at n = 4096 (the coefficient form, `poly_coefficients`) and one forward
FFT at n = 8192 (the extension over the whole bit-reversed extended
domain), bit-exact against the spec's `compute_cells`.  On the device
route each transform is one `ops.fr_batch.fr_fft` (K18); the host route
is the recursive `_fft`, the oracle's shape.  `device` follows
`das.verify.device_for`.

The proofs use one identity: on cell k's coset every point satisfies
x^64 = a_k, so the quotient of f by X^64 - a_k groups the coefficients
by residue mod 64, Q_k[t] = sum_(u >= 1) f[t + 64 u] a_k^(u-1), with no
long division (`_quotient_scalars`).  One column's proof is one MSM over
that (`cell_proof_for_column`); all 128 come from FK20 on the device
(`_fk20_proofs_device`: K18 at batch 64, n = 128, then K20, K19 inverse,
the gather and mask of row 15', K19 forward, the setup tables kept on
the device), or from the D_u partial route on the host (`_du_proofs`).
`compute_cells_and_kzg_proofs` picks FK20 on a device, D_u on the host
route, or the one `route` names.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import resolve_device
from ..ops.bls import curve as _curve
from . import ciphersuite as cs
from .verify import device_for

M = cs.FIELD_ELEMENTS_PER_BLOB
L = cs.FIELD_ELEMENTS_PER_CELL
P = cs.BLS_MODULUS
K = M // L                      # residue classes / points per FK20 vector
N_EXT = cs.CELLS_PER_EXT_BLOB   # FK20 circulant order (128)


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


def _cells_of(ext) -> list[bytes]:
    """The 128 cells of the extension given in natural order."""
    ext_brp = [ext[cs.reverse_bits(i, 2 * M)] for i in range(2 * M)]
    return [cs._encode_evals(ext_brp[k * L:(k + 1) * L])
            for k in range(cs.CELLS_PER_EXT_BLOB)]


def compute_cells(blob: bytes, device=None) -> list[bytes]:
    """All 128 cells of the extended blob via one size-8192 FFT —
    bit-exact against the spec's `compute_cells`."""
    coeffs = poly_coefficients(blob, device=device)
    return _cells_of(_extended_evals(coeffs, device=device))


# --- proofs ------------------------------------------------------------------


def _a_k(cell_index: int) -> int:
    return pow(cs.coset_shift(cell_index), L, P)


def _msm(points, scalars, device):
    """MSM returning an oracle Jacobian point, the zero scalars and the
    points at infinity dropped: `ops.bls_batch.g1_multi_exp_device` on
    the device `device_for(device)` names, the host Pippenger on the
    host route."""
    live = [(p, int(s) % P) for p, s in zip(points, scalars)
            if int(s) % P != 0 and not _curve.g1.is_inf(p)]
    if not live:
        return _curve.g1.infinity()
    dev = device_for(device)
    if dev is not None:
        from ..ops.bls_batch import g1_multi_exp_device

        return g1_multi_exp_device([p for p, _ in live],
                                   [s for _, s in live], device=dev)
    return _curve.g1.msm([p for p, _ in live], [s for _, s in live])


def _setup_msm(scalars, device):
    """sum_t scalars[t] [s^t]: `_msm` over the monomial setup, parsing
    only the points whose scalar is not zero."""
    live = [(t, int(s) % P) for t, s in enumerate(scalars) if int(s) % P]
    return _msm([cs.setup_g1_point(t) for t, _ in live],
                [s for _, s in live], device)


def _quotient_scalars(coeffs, a_k: int) -> list[int]:
    """Q_k's 4032 coefficients via the residue-mod-64 grouping (no
    long division) — identical to `divide_polynomialcoeff(f, Z_k)`."""
    out = [0] * (M - L)
    for c in range(L):
        # walk residue class c from the top so each step is one
        # multiply: Q[t] = f[t + 64] + a_k * Q[t + 64]
        acc = 0
        for v in range((M - L) // L - 1, -1, -1):
            t = c + v * L
            acc = (coeffs[t + L] + a_k * acc) % P
            out[t] = acc
    return out


def cell_proof_for_column(blob: bytes, cell_index: int, device=None) -> bytes:
    """One column's KZG multiproof for `blob`: one scalar pass and one
    MSM over the setup (K13 or K14 on the device).  Byte-equal to the
    proof the oracle's `compute_cells_and_kzg_proofs` emits at this
    index."""
    coeffs = poly_coefficients(blob, device=device)
    q = _quotient_scalars(coeffs, _a_k(int(cell_index)))
    return _curve.g1_to_bytes(_setup_msm(q, device))


@functools.lru_cache(maxsize=8)
def _cached_cells_and_column_proofs(blob: bytes, columns: tuple, device):
    cells = compute_cells(blob, device=device)
    proofs = {k: cell_proof_for_column(blob, k, device=device)
              for k in columns}
    return cells, proofs


def cells_and_column_proofs(blob: bytes, columns, device=None):
    """(all 128 cells, {column: proof}) with a small per-process memo."""
    return _cached_cells_and_column_proofs(
        bytes(blob), tuple(int(c) for c in columns), device)


# --- FK20: all proofs from O(log) FFTs + one MSM -----------------------------
#
# Every cell coset satisfies x^64 = a_k = w_128^rev7(k), so the 128 proofs
# are the order-128 G1 FFT of the D_u partials,
#
#     proofs (cell order) = brp( FFT_128([D_1 .. D_63, inf x 65]) ),
#
# and the D_u factor through per-residue circular convolutions against
# the setup: with b^c_m = f[c + 64 m] and x^c_v = [s^(c + 64 v)],
#
#     D_u = [ IFFT_128( sum_c FFT_fr(B^c) * X_fft^c ) ]_((128 - u) mod 128)
#
# where B^c is the circulant embedding (B_0 = b_0, B_(128-m) = b_m) and
# X_fft^c the G1 FFT of [x^c_0 .. x^c_63, inf x 64] (`_fk20_setup_tables`).


@functools.lru_cache(maxsize=4)
def _fk20_setup_tables(device: torch.device):
    """The X_fft tables on `device`, (X, Y, Z) each (L, N_EXT, 33): one
    batched G1 FFT (K19 at (64, 128)) the first time a proof is made on
    that device, kept for the life of the process."""
    from ..ops.bls_batch import g1fft as gf

    xs, ys, zs = [], [], []
    for c in range(L):
        pts = [cs.setup_g1_point(c + L * v) for v in range(K)]
        x, y, z = gf.points_to_limbs(pts, pad_to=N_EXT)
        xs.append(x)
        ys.append(y)
        zs.append(z)
    return gf.g1_fft_device(np.stack(xs), np.stack(ys), np.stack(zs),
                            device=device)


@functools.lru_cache(maxsize=8)
def _domain_consts(n: int, inverse: bool, device: torch.device):
    """K18's constants for the order-n domain on `device`: the bit
    reversal as an index, the (reversed, for the inverse) roots and the
    scale (1/n for the inverse) as Montgomery limbs."""
    from ..ops import fr_batch as FB

    roots = tuple(cs.roots_of_unity(n))
    if inverse:
        roots = (roots[0],) + roots[:0:-1]
    scale = pow(n, P - 2, P) if inverse else 1
    perm = torch.tensor(FB._bitrev_perm(n), device=device)
    return (perm, torch.from_numpy(FB.FR.to_mont_batch(list(roots))).to(device),
            torch.from_numpy(FB.FR.to_mont(scale)).to(device))


def domain_fft(x: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """The FFT (or inverse) over the order-n roots of unity of each row
    of Montgomery limbs x (B, n, 33), natural order in and out, on x's
    device: the bit reversal by device indexing, then K18 (its plain
    version on the CPU)."""
    from ..ops import fr_batch as FB

    perm, roots, scale = _domain_consts(int(x.shape[1]), bool(inverse),
                                        x.device)
    return FB.fft(x[:, perm].contiguous(), roots, scale)


def _coeff_limbs(coeffs, dev: torch.device) -> torch.Tensor:
    """Coefficients as Montgomery limbs (M, 33) on `dev`: ints are
    converted, a limb tensor is kept."""
    if isinstance(coeffs, torch.Tensor):
        return coeffs.to(dev)
    from ..ops.fr_batch import FR

    return torch.from_numpy(FR.to_mont_batch([int(c) for c in coeffs])).to(
        dev)


@functools.lru_cache(maxsize=4)
def _fk20_row_index(l: int, k: int, n_ext: int, m: int,
                    device: torch.device) -> torch.Tensor:
    """(l, n_ext) gather index of the circulant rows into the m
    coefficients with a zero row appended at m: row c holds f[c] at 0
    and f[c + l j] at n_ext - j (j = 1 .. k - 1)."""
    idx = np.full((l, n_ext), m, dtype=np.int64)
    for c in range(l):
        idx[c, 0] = c
        for j in range(1, k):
            idx[c, n_ext - j] = c + l * j
    return torch.from_numpy(idx).to(device)


@functools.lru_cache(maxsize=4)
def _fk20_gather(k: int, n_ext: int, device: torch.device):
    """Row 15': the index E_d = C_(n_ext-1-d) and the mask d < k - 1."""
    idx = torch.tensor([(n_ext - 1 - d) % n_ext for d in range(n_ext)],
                       device=device)
    keep = torch.arange(n_ext, device=device) < (k - 1)
    return idx, keep[None, :, None]


def _fk20_proofs_device(coeffs, device="cuda") -> list[bytes]:
    """All N_EXT compressed proofs of a coefficient-form blob polynomial
    (ints, or Montgomery limbs on the device) by FK20 on `device`: the
    circulant rows gathered on the device, one batched field FFT (K18),
    the scalars' window digits on the device (K15 takes them out of
    Montgomery form), the hext MSM (K20), the G1 inverse FFT (K19), the
    gather and mask of row 15' by device indexing, the G1 FFT (K19);
    the points come to the host once, to be compressed."""
    from ..ops import fr_batch as FB
    from ..ops.bls_batch import g1fft as gf

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:   # one cache key a card
        dev = torch.device("cuda", torch.cuda.current_device())
    f = _coeff_limbs(coeffs, dev)[:M]
    padded = torch.cat([f, torch.zeros((1, f.shape[1]), dtype=f.dtype,
                                       device=dev)])
    rows = padded[_fk20_row_index(L, K, N_EXT, M, dev)]   # (L, N_EXT, 33)
    sfft = domain_fft(rows)
    raw_one = torch.from_numpy(FB.FR.int_to_limbs(1)).to(dev)
    ints = FB.field_op("mul", sfft, raw_one.expand(sfft.shape).contiguous())
    hext = gf.hext(*_fk20_setup_tables(dev), gf.limb_digits(ints))
    cg = gf.g1_fft_device(*(c[None] for c in hext), inverse=True,
                          device=dev)
    idx, keep = _fk20_gather(K, N_EXT, dev)
    ex, ey, ez = (c[:, idx] for c in cg)
    ez = torch.where(keep, ez, torch.zeros_like(ez))
    out = gf.g1_fft_device(ex, ey, ez, device=dev)
    pts = gf.limbs_to_oracle_list(out)
    return [_curve.g1_to_bytes(pts[cs.reverse_bits(k, N_EXT)])
            for k in range(N_EXT)]


def _du_proofs(coeffs, device) -> list[bytes]:
    """The D_u route: 63 shared partial MSMs D_u = sum_t f[t + 64 u]
    [s^t], then one 63-point MSM per column, W_k = sum_u a_k^(u-1) D_u —
    the host route's producer."""
    d_points = [_setup_msm(coeffs[u * L:], device) for u in range(1, K)]
    proofs = []
    for k in range(N_EXT):
        a = _a_k(k)
        pows, cur = [], 1
        for _ in range(len(d_points)):
            pows.append(cur)
            cur = cur * a % P
        proofs.append(_curve.g1_to_bytes(_msm(d_points, pows, device)))
    return proofs


def _producer_route(dev) -> str:
    """FK20 on a device, the D_u route on the host route."""
    return "du" if dev is None else "fk20"


def compute_cells_and_kzg_proofs(blob: bytes, device=None, route=None):
    """All 128 cells and all 128 proofs of `blob`, byte-equal to the
    spec oracle's: FK20 on the device (`device` as in `device_for`;
    the facade's default is CUDA), the D_u route on the host route, or
    the one `route` ("fk20" or "du") names."""
    dev = device_for(device)
    if route is None:
        route = _producer_route(dev)
    assert route in ("fk20", "du"), route
    coeffs = poly_coefficients(blob, device=device)
    cells = _cells_of(_extended_evals(coeffs, device=device))
    if route == "fk20":
        proofs = _fk20_proofs_device(coeffs, device=dev or "cuda")
    else:
        proofs = _du_proofs(coeffs, device)
    return cells, proofs
