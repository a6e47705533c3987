"""Batched G1 FFT and the FK20 circulant MSM (counterpart of the JAX
package's `ops/bls_batch/g1fft_jax.py`): the producer kernels behind
`das/compute.py`'s all-proofs path.

FK20 factors the 128 cell proofs of one blob through three linear stages
over the order-128 root-of-unity domain:

    hext_j = sum_c  FFT_fr(B^c)_j * X_fft^c_j      (the one MSM)
    C      = IFFT_G1(hext);  E_d = C_(127-d) (d < 63), infinity otherwise
    proofs = brp( FFT_G1(E) )

where X_fft^c is the G1 FFT of the residue-c trusted-setup vector, built
once per process and device by one batched G1 FFT (`das/compute.py` keeps
it; this module holds the kernels).

A G1 FFT is the field FFT with the twiddle product lifted to
scalar-times-point: log2(n) butterfly rounds, each a windowed scalar
multiplication of the v half by its host-known twiddle (64 4-bit window
steps over a 16-entry multiple table) and two point additions.  Shapes
ride the rung ladder `g1fft_rung`; padded lanes are the point at
infinity, which the branchless formulas absorb.

Each stage is a kernel on a CUDA tensor and its plain PyTorch version on
a CPU tensor (or with `plain=True`):

    fft    K19  the batched (inverse) G1 FFT of bit-reversed rows
    hext   K20  FK20's per-position window-4 Pippenger MSMs

The plain versions run JAX's programs (`_g1_fft_kernel`,
`_fk20_hext_kernel`, with Python loops for `lax.scan` and a leading axis
of positions for `vmap`) on the port's plain curve layer, so on the CPU
every coordinate equals JAX's limb for limb; the kernels return
canonical limbs, equal to `fq_canon` of the plain ones.  Neither falls
back to the other when a kernel fails to build or launch.

The async facade (`g1_fft_async`) is not ported yet.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ... import resolve_device
from ..bls import curve as _pycurve
from . import curve as C
from . import fq as _fq
from . import kernels as K

R_MODULUS = _pycurve.R

# primitive root of the scalar field (the KZG PRIMITIVE_ROOT_OF_UNITY)
_PRIMITIVE_ROOT = 7
# windowed twiddle multiply: a 16-entry table per butterfly lane, 64 steps
_TW_WINDOW = 4
# the FK20 hext MSMs are 64 points each: 16 buckets a window
_FK20_WINDOW = 4
SCALAR_BITS = 255
N_DIGITS = -(-SCALAR_BITS // _TW_WINDOW)    # 64
# point-vector shape ladder (JAX `:69`): the parity domains, then FK20's
_G1FFT_STEPS = (8, 128)


def _use_kernel(t: torch.Tensor, plain: bool) -> bool:
    return t.device.type == "cuda" and not plain


def g1fft_rung(n: int) -> int:
    """Padded point-vector shape for an n-point transform (JAX `:71`)."""
    b = 1 if n <= 1 else 1 << (n - 1).bit_length()
    for step in _G1FFT_STEPS:
        if b <= step:
            return step
    return b


@functools.lru_cache(maxsize=8)
def fft_domain(n: int) -> tuple:
    """Order-n roots of unity w^0 .. w^(n-1), w = 7^((r-1)/n) (JAX
    `:83`, the derivation of `das.ciphersuite.roots_of_unity`)."""
    assert n and n & (n - 1) == 0
    w = pow(_PRIMITIVE_ROOT, (R_MODULUS - 1) // n, R_MODULUS)
    return tuple(pow(w, i, R_MODULUS) for i in range(n))


@functools.lru_cache(maxsize=8)
def _bitrev_perm(n: int) -> tuple:
    bits = n.bit_length() - 1
    return tuple(int(f"{i:0{bits}b}"[::-1], 2) if bits else 0
                 for i in range(n))


@functools.lru_cache(maxsize=8)
def _stage_plan(n: int, inverse: bool) -> tuple:
    """The butterfly schedule (JAX `:99`): (u_idx, v_idx, digits) over
    the log2(n) rounds.  Round s (half-width h = 2^s) pairs positions
    (b 2h + i, b 2h + h + i) and multiplies the v half by
    roots[i n / (2h)], as 64 most-significant-first 4-bit digits."""
    roots = list(fft_domain(n))
    if inverse:
        roots = [roots[0]] + roots[:0:-1]
    half = n // 2
    u_rows, v_rows, d_rows = [], [], []
    h = 1
    while h < n:
        stride = n // (2 * h)
        u_idx = np.empty(half, dtype=np.int32)
        v_idx = np.empty(half, dtype=np.int32)
        tw = []
        for lane in range(half):
            b, i = divmod(lane, h)
            u_idx[lane] = b * 2 * h + i
            v_idx[lane] = u_idx[lane] + h
            tw.append(roots[i * stride])
        u_rows.append(u_idx)
        v_rows.append(v_idx)
        d_rows.append(C.scalars_to_digits(tw, SCALAR_BITS, _TW_WINDOW))
        h *= 2
    return (np.stack(u_rows), np.stack(v_rows), np.stack(d_rows))


@functools.lru_cache(maxsize=8)
def _inv_bits(n: int) -> np.ndarray:
    """The bits of 1/n mod r, most significant first (the inverse's
    final fixed scalar multiply)."""
    inv_n = pow(n, R_MODULUS - 2, R_MODULUS)
    return np.array([int(b) for b in bin(inv_n)[2:]], dtype=np.int32)


@functools.lru_cache(maxsize=16)
def _plan_tensors(n: int, inverse: bool, device: torch.device):
    """K19's host constants on `device`, uploaded once per (n, inverse)."""
    u, v, d = _stage_plan(n, inverse)
    bits = _inv_bits(n) if inverse else np.zeros(0, np.int32)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (u, v, d, bits))


# --- K19 ----------------------------------------------------------------------


def _windowed_mul(v, digs):
    """v -> k v for per-lane scalars given as window digits (JAX `:130`):
    v's coordinates (B, h, 33), digs (h, 64).  A 16-entry multiple table
    (evens by doubling, odds by one add), then per window 4 doublings and
    one add of the gathered entry (digit 0 gathers infinity)."""
    F = C.F1
    T = [C.pt_infinity(F, v), v]
    for d in range(2, 1 << _TW_WINDOW):
        T.append(C.pt_double(F, T[d // 2]) if d % 2 == 0
                 else C.pt_add(F, T[d - 1], v))
    table = tuple(torch.stack([t[i] for t in T]) for i in range(3))
    lane = torch.arange(v[0].shape[-2], device=v[0].device)
    acc = C.pt_infinity(F, v)
    for w in range(digs.shape[-1]):
        for _ in range(_TW_WINDOW):
            acc = C.pt_double(F, acc)
        d = digs[:, w].long()
        sel = tuple(tc[d, :, lane].movedim(0, 1) for tc in table)
        acc = C.pt_add(F, acc, sel)
    return acc


def fft_plain(x, y, z, inverse: bool = False):
    """JAX `_g1_fft_kernel`'s program (`:161`) on (B, n, 33) coordinates
    in bit-reversed order; natural-order Jacobian output, JAX's limbs."""
    n = x.shape[1]
    u_all, v_all, d_all = (torch.from_numpy(np.ascontiguousarray(a)).to(
        x.device) for a in _stage_plan(n, bool(inverse)))
    p = (x, y, z)
    for s in range(u_all.shape[0]):
        u_idx, v_idx = u_all[s].long(), v_all[s].long()
        u = tuple(c[:, u_idx] for c in p)
        t = _windowed_mul(tuple(c[:, v_idx] for c in p), d_all[s])
        plus = C.pt_add(C.F1, u, t)
        minus = C.pt_add(C.F1, u, C.pt_neg(C.F1, t))
        nxt = []
        for c, pl, mi in zip(p, plus, minus):
            c = c.clone()
            c[:, u_idx] = pl
            c[:, v_idx] = mi
            nxt.append(c)
        p = tuple(nxt)
    if inverse:
        p = C.pt_scalar_mul_const(C.F1, p, _inv_bits(n))
    return p


def fft(x, y, z, inverse: bool = False, plain: bool = False):
    """The G1 FFT (or inverse, with its 1/n) of each row of (x, y, z),
    each (B, n, 33) Jacobian limbs in BIT-REVERSED order (Z = 0 is
    infinity); natural order out.  K19 on a CUDA tensor (canonical), the
    plain version otherwise (JAX's limbs)."""
    if _use_kernel(x, plain):
        n = x.shape[1]
        plan = _plan_tensors(n, bool(inverse), x.device)
        return K.g1_fft_kernel(x.contiguous(), y.contiguous(),
                               z.contiguous(), *plan)
    return fft_plain(x, y, z, inverse)


# --- K20 ----------------------------------------------------------------------


def hext_plain(x, y, z, digits):
    """JAX `_fk20_hext_kernel`'s program (`:202`): `pt_msm_pippenger` at
    window 4 for each position j, the positions as a leading axis in
    place of `vmap`.  Points (R, width, 33), digits (R, width, 64);
    returns (X, Y, Z), each (width, 33), JAX's limbs."""
    F = C.F1
    R, width = digits.shape[0], digits.shape[1]
    W = digits.shape[2]
    nb = 1 << _FK20_WINDOW
    dev = x.device
    one = _fq.const(F.one, dev).expand((width, W, nb, 33))
    buckets = [one.clone(), one.clone(),
               torch.zeros((width, W, nb, 33), dtype=torch.int32,
                           device=dev)]
    jidx = torch.arange(width, device=dev)[:, None]
    widx = torch.arange(W, device=dev)[None, :]
    for i in range(R):                      # the residue rows in order
        d = digits[i].long()
        cur = tuple(b[jidx, widx, d] for b in buckets)
        pt = tuple(co[i][:, None, :].expand(width, W, 33)
                   for co in (x, y, z))
        for b, nc in zip(buckets, C.pt_add(F, cur, pt)):
            b[jidx, widx, d] = nc
    # suffix sum over k = nb-1 .. 1, width x W wide
    running = acc = C.pt_infinity(F, tuple(b[:, :, 0] for b in buckets))
    for k in range(nb - 1, 0, -1):
        running = C.pt_add(F, running, tuple(b[:, :, k] for b in buckets))
        acc = C.pt_add(F, acc, running)
    res = C.pt_infinity(F, tuple(a[:, 0] for a in acc))
    for w in range(W):
        for _ in range(_FK20_WINDOW):
            res = C.pt_double(F, res)
        res = C.pt_add(F, res, tuple(a[:, w] for a in acc))
    return res


def hext(x, y, z, digits, plain: bool = False):
    """hext_j = sum_c k[c, j] X[c, j] for each position j: points
    (R, width, 33) Jacobian, digits (R, width, 64) 4-bit windows most
    significant first.  K20 on a CUDA tensor (canonical), the plain
    version otherwise (JAX's limbs)."""
    if _use_kernel(x, plain):
        return K.fk20_hext_kernel(x.contiguous(), y.contiguous(),
                                  z.contiguous(), digits.contiguous())
    return hext_plain(x, y, z, digits)


# --- host and device conversions ----------------------------------------------


def points_to_limbs(points, pad_to: int | None = None):
    """Oracle Jacobian points -> (x, y, z) Montgomery limb stacks, numpy
    (n, 33) each, infinity as (1, 1, 0) (JAX `:225`); `pad_to` appends
    infinity lanes."""
    n = pad_to if pad_to is not None else len(points)
    one = _fq.to_mont(1)
    xs = np.zeros((n, _fq.N_LIMBS), dtype=np.int32)
    ys = np.zeros((n, _fq.N_LIMBS), dtype=np.int32)
    zs = np.zeros((n, _fq.N_LIMBS), dtype=np.int32)
    xs[:], ys[:] = one, one
    for i, p in enumerate(points):
        aff = _pycurve.g1.to_affine(p)
        if aff is None:
            continue
        xs[i] = _fq.to_mont(aff[0])
        ys[i] = _fq.to_mont(aff[1])
        zs[i] = one
    return xs, ys, zs


def limbs_to_oracle_list(p) -> list:
    """Jacobian coordinate stacks (..., n, 33) -> oracle Jacobian tuples,
    the leading axes flattened (JAX `:246`)."""
    X, Y, Z = (np.asarray(c.cpu() if isinstance(c, torch.Tensor) else c)
               .reshape(-1, _fq.N_LIMBS) for c in p)
    return [(_fq.from_mont(x), _fq.from_mont(y), _fq.from_mont(z))
            for x, y, z in zip(X, Y, Z)]


def limb_digits(t: torch.Tensor) -> torch.Tensor:
    """Canonical limbs (..., 33) of plain integers (not Montgomery form)
    -> (..., 64) int32 4-bit window digits, most significant first, on
    the tensor's device (each 12-bit limb is three digits)."""
    limbs = t[..., :22]
    nib = torch.stack([limbs & 15, (limbs >> 4) & 15, (limbs >> 8) & 15],
                      dim=-1).reshape(t.shape[:-1] + (66,))
    return nib[..., :N_DIGITS].flip(-1).contiguous()


def _coords_to(coords, dev):
    return tuple(c.to(dev) if isinstance(c, torch.Tensor) else
                 torch.from_numpy(np.array(c, dtype=np.int32)).to(dev)
                 for c in coords)


# --- entry points ---------------------------------------------------------------


def g1_fft_device(x, y, z, inverse: bool = False, device="cuda"):
    """G1 (inverse) FFT of (B, n, 33) coordinates in NATURAL order
    (tensors or numpy) on `device` (JAX `:257`): the bit-reversal
    permutation is device indexing, then K19 (the plain version on the
    CPU).  Returns the device coordinates (X, Y, Z), natural order."""
    dev = resolve_device(device)
    x, y, z = _coords_to((x, y, z), dev)
    perm = torch.tensor(_bitrev_perm(int(x.shape[1])), device=dev)
    return fft(*(c[:, perm] for c in (x, y, z)), inverse=inverse)


def g1_fft(points, inverse: bool = False, device="cuda") -> list:
    """G1 FFT of an oracle point vector over the order-`g1fft_rung(n)`
    domain (short vectors zero-padded), as a list of oracle Jacobian
    points (JAX `:309 g1_fft`): out_i = sum_j w^(i j) P_j."""
    n_live = len(points)
    assert n_live >= 1
    x, y, z = points_to_limbs(points, pad_to=g1fft_rung(n_live))
    out = g1_fft_device(x[None], y[None], z[None], inverse=inverse,
                        device=device)
    return limbs_to_oracle_list(out)


def fk20_hext_device(x, y, z, scalars, device="cuda"):
    """The FK20 'one MSM' on `device` (JAX `:314`): setup-table
    coordinates (R, width, 33) against host canonical scalar rows (R x
    width ints) -> device coordinates (X, Y, Z), each (width, 33), of
    hext_j = sum_c scalars[c][j] X[c][j].  K20, the plain version on the
    CPU."""
    dev = resolve_device(device)
    x, y, z = _coords_to((x, y, z), dev)
    R, width = int(x.shape[0]), int(x.shape[1])
    flat = [int(s) % R_MODULUS for row in scalars for s in row]
    assert len(flat) == R * width
    digits = torch.from_numpy(C.scalars_to_digits(
        flat, SCALAR_BITS, _FK20_WINDOW).reshape(R, width, N_DIGITS)).to(dev)
    return hext(x, y, z, digits)
