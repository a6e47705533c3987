"""Wrappers of the scalar-field kernels K15-K18 (`csrc/fr_batch.cu`, over
the device arithmetic of `csrc/fr.cuh`).

Each wrapper takes and returns the port's boundary format (JAX's
(..., 33) int32 limbs, R = 2**396; outputs canonical), checks its inputs,
launches on the current stream, raises on a refused launch and adds one to
its launch count.  It never falls back to a plain version: the plain
versions and the dispatch by device live in `ops/fr_batch/__init__.py`.

The kernels' constants are not typed into the source: `constant_words`
derives them from the modulus, and `lib_for` writes them into the
library's `__constant__` block once per device.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ... import _build
from .field import N_LIMBS, R_MODULUS

N_WORDS = 8            # 32-bit words of a kernel Fr
R_KERNEL = 1 << 256    # the kernels' Montgomery R
COSET_THREADS = 512    # K17's fold: threads a block (`kCosetThreads`)
COSET_WIDTH = 256      # K17's W, at most (`kCosetWidth`)
COSET_COLS = 32        # its column tile, at most (`kCosetCols`)
COSET_INNER = 64       # its inner tile, at most (`kCosetInner`)
COSET_MIN_INNER = 4    # its inner tile, at least (`kCosetMinInner`)
COSET_FILL = 128       # fold blocks aimed at (`kCosetFill`)
FFT_TILE = 128         # K18's tile T (`kFftTile`)
FFT_CLASS_MAX = 512    # n / FFT_TILE, at most, for n > FFT_TILE
INV_BLOCK = 256        # K15's batch inverse: threads a block (`kInvBlock`)

# op name -> (code, inputs)
FIELD_OPS = {"mul": (0, 2), "add": (1, 2), "sub": (2, 2), "inv": (3, 1),
             "pow": (4, 1), "canon": (5, 1)}


def words(x: int) -> list[int]:
    return [(x >> (32 * i)) & 0xFFFFFFFF for i in range(N_WORDS)]


def constant_words() -> np.ndarray:
    """The `FrConstants` block of `fr.cuh`, in its field order, as uint32
    words: r, r - 2, the Montgomery one, the boundary conversion factors
    and -r^-1 mod 2^32."""
    r = R_MODULUS
    w = (words(r) + words(r - 2) + words(R_KERNEL % r)
         + words(pow(2, 116, r)) + words(pow(2, 372, r))
         + words(pow(2, 512, r)) + words(pow(2, 396, r))
         + [(-pow(r, -1, 1 << 32)) % (1 << 32)])
    out = np.array(w, dtype=np.uint32)
    assert out.size == 57
    return out


_p, _i32, _i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_SIGNATURES = {
    "fr_set_constants": [_p, _i32],
    "fr_field_ops_launch": [_i32, _p, _p, _p, _p, _i64, _p],
    "fr_barycentric_launch": [_p] * 5 + [_i32, _p, _p, _p],
    "fr_coset_interpolate_launch": [_p] * 3 + [_i32, _i32, _p, _p, _p],
    "fr_fft_launch": [_p] * 3 + [_i32, _i32, _p, _p, _p],
    "fr_batch_inverse_launch": [_p, _i64, _p, _p, _p],
    "fr_product_chain_launch": [_p, _i32, _p, _p],
}
_SCRATCH = {"fr_barycentric_scratch_bytes": [_i32],
            "fr_coset_scratch_bytes": [_i32] * 2,
            "fr_fft_scratch_bytes": [_i32] * 2,
            "fr_batch_inverse_scratch_bytes": [_i64]}


@functools.cache
def _lib_loaded():
    lib = _build.load("fr_batch")
    for f, args in _SIGNATURES.items():
        getattr(lib, f).argtypes = args
        getattr(lib, f).restype = _i32
    for f, args in _SCRATCH.items():
        getattr(lib, f).argtypes = args
        getattr(lib, f).restype = _i64
    return lib


@functools.cache
def _lib(device_index: int):
    lib = _lib_loaded()
    with torch.cuda.device(device_index):
        w = constant_words()
        _build.check(lib.fr_set_constants(w.ctypes.data, w.size),
                     "fr_set_constants")
    return lib


def lib_for(device) -> ctypes.CDLL:
    """The `fr_batch` library with its constants on `device` (CUDA)."""
    dev = torch.device(device)
    return _lib(dev.index if dev.index is not None
                else torch.cuda.current_device())


def _limbs(name: str, t: torch.Tensor, shape: tuple) -> None:
    if t.dtype != torch.int32 or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected int32 {tuple(shape)}, got "
                         f"{t.dtype} {tuple(t.shape)}")


def _scratch(dev, nbytes: int) -> torch.Tensor:
    return torch.empty(max(16, int(nbytes)), dtype=torch.uint8, device=dev)


# --- K15 -------------------------------------------------------------------


def field_op_kernel(op: str, a: torch.Tensor, b=None, e: int = 0):
    """K15: `op` elementwise over (..., 33) limbs (`pow` by the fixed
    exponent `e` < 2**256); canonical output of `a`'s shape."""
    if op not in FIELD_OPS:
        raise ValueError(f"unknown field op {op!r}")
    code, n_in = FIELD_OPS[op]
    if a.dtype != torch.int32 or a.shape[-1] != N_LIMBS:
        raise ValueError(f"{op}: expected int32 (..., 33), got {a.dtype} "
                         f"{tuple(a.shape)}")
    if not 0 <= e < R_KERNEL:
        raise ValueError(f"{op}: exponent out of range")
    a = a.contiguous()
    if n_in == 2:
        if b is None or b.shape != a.shape or b.dtype != torch.int32:
            raise ValueError(f"{op}: b must match a's shape and dtype")
        b = b.contiguous()
    else:
        b = a
    out = torch.empty_like(a)
    _build.require_cuda("fr_field_ops", a, b, out)
    n = a.numel() // N_LIMBS
    exp = np.array(words(e), dtype=np.uint32)
    if n:
        _build.check(lib_for(a.device).fr_field_ops_launch(
            code, exp.ctypes.data, a.data_ptr(), b.data_ptr(),
            out.data_ptr(), n, _build.stream_ptr(a)), "fr_field_ops")
        _build.launches["fr_field_ops"] += 1
    return out


def batch_inverse_kernel(x: torch.Tensor) -> torch.Tensor:
    """K15's batch inverse: Montgomery's trick over x (n, 33) in one
    cooperative launch, a thread an element, or a run of them where n
    passes INV_BLOCK times its blocks (at most 256, all co-resident);
    canonical (n, 33).  A zero element makes every output 0.  Counted as
    K15's launch (`fr_field_ops`)."""
    _limbs("x", x, (x.shape[0], N_LIMBS))
    n = x.shape[0]
    if n < 1:
        raise ValueError(f"fr_batch_inverse: n {n}")
    x = x.contiguous()
    lib = lib_for(x.device)
    scratch = _scratch(x.device, lib.fr_batch_inverse_scratch_bytes(n))
    out = torch.empty_like(x)
    _build.require_cuda("fr_batch_inverse", x, scratch, out)
    _build.check(lib.fr_batch_inverse_launch(
        x.data_ptr(), n, scratch.data_ptr(), out.data_ptr(),
        _build.stream_ptr(x)), "fr_batch_inverse")
    _build.launches["fr_field_ops"] += 1
    return out


def fr_product_chain(a: torch.Tensor, n: int) -> torch.Tensor:
    """A probe, on no path: a^(2^n) (a: (33,) limbs) by n dependent Fr
    products on one thread; its time over n is the product's latency.
    Not counted in `launches`."""
    _limbs("fr_product_chain", a, (N_LIMBS,))
    out = torch.empty(N_LIMBS, dtype=torch.int32, device=a.device)
    _build.require_cuda("fr_product_chain", a, out)
    _build.check(lib_for(a.device).fr_product_chain_launch(
        a.data_ptr(), int(n), out.data_ptr(), _build.stream_ptr(a)),
        "fr_product_chain")
    return out


# --- K16 -------------------------------------------------------------------


def barycentric_kernel(poly, roots, z, h_pow_w, inv_scale):
    """K16: f(z) over the W-point domain `roots` (W, 33), z, h^W and
    1 / (W h^W) (33,) each; one canonical (33,) value."""
    W = poly.shape[0]
    if W < 1:
        raise ValueError("fr_barycentric: empty domain")
    for name, t, shape in (("poly", poly, (W, 33)), ("roots", roots, (W, 33)),
                           ("z", z, (33,)), ("h_pow_w", h_pow_w, (33,)),
                           ("inv_scale", inv_scale, (33,))):
        _limbs(name, t, shape)
    dev = poly.device
    lib = lib_for(dev)
    scratch = _scratch(dev, lib.fr_barycentric_scratch_bytes(W))
    out = torch.empty(33, dtype=torch.int32, device=dev)
    args = (poly, roots, z, h_pow_w, inv_scale)
    _build.require_cuda("fr_barycentric", *args, scratch, out)
    _build.check(lib.fr_barycentric_launch(
        *(t.data_ptr() for t in args), W, scratch.data_ptr(), out.data_ptr(),
        _build.stream_ptr(poly)), "fr_barycentric")
    _build.launches["fr_barycentric"] += 1
    return out


# --- K17 -------------------------------------------------------------------


def coset_shape(B: int, W: int) -> dict:
    """K17's fold tiles (`coset_shape` in the source): tj columns, tb
    rows (one a thread), ic inner indices (halved from min(W,
    COSET_INNER) down to COSET_MIN_INNER while the blocks fall short of
    COSET_FILL) and the block count."""
    tj = min(W, COSET_COLS)
    tb = COSET_THREADS // tj
    tiles = -(-B // tb) * (W // tj)
    ic = min(W, COSET_INNER)
    while ic > COSET_MIN_INNER and tiles * (W // ic) < COSET_FILL:
        ic //= 2
    return {"tj": tj, "tb": tb, "ic": ic, "blocks": tiles * (W // ic)}


def coset_interpolate_kernel(evals, idft, weights):
    """K17: S_j = sum_b weights[b, j] sum_i evals[b, i] idft[i, j] for
    evals and weights (B, W, 33), idft (W, W, 33), W a power of two up to
    256; canonical (W, 33).  Two launches (the inputs packed into word
    planes; the tiled fold with its lazy sums and the last block's sum of
    the partials), counted as one call."""
    B, W = evals.shape[0], evals.shape[1]
    if B < 1 or W < 1 or W & (W - 1) or W > COSET_WIDTH:
        raise ValueError(f"fr_coset_interpolate: batch {B}, width {W}")
    for name, t, shape in (("evals", evals, (B, W, 33)),
                           ("idft", idft, (W, W, 33)),
                           ("weights", weights, (B, W, 33))):
        _limbs(name, t, shape)
    dev = evals.device
    lib = lib_for(dev)
    scratch = _scratch(dev, lib.fr_coset_scratch_bytes(B, W))
    out = torch.empty((W, 33), dtype=torch.int32, device=dev)
    _build.require_cuda("fr_coset_interpolate", evals, idft, weights,
                        scratch, out)
    _build.check(lib.fr_coset_interpolate_launch(
        evals.data_ptr(), idft.data_ptr(), weights.data_ptr(), B, W,
        scratch.data_ptr(), out.data_ptr(), _build.stream_ptr(evals)),
        "fr_coset_interpolate")
    _build.launches["fr_coset_interpolate"] += 1
    return out


# --- K18 -------------------------------------------------------------------


def fft_kernel(x, roots, scale):
    """K18: the radix-2 DIT FFT of each row of x (batch, n, 33), given in
    bit-reversed order, over the domain `roots` (n, 33), times `scale`
    (33,); canonical (batch, n, 33) in natural order.  One launch where a
    row fits the tile (n <= FFT_TILE), two otherwise."""
    batch, n = x.shape[0], x.shape[1]
    if batch < 1 or n < 2 or n & (n - 1) or n > FFT_TILE * FFT_CLASS_MAX:
        raise ValueError(f"fr_fft: batch {batch}, n {n}")
    for name, t, shape in (("x", x, (batch, n, 33)), ("roots", roots, (n, 33)),
                           ("scale", scale, (33,))):
        _limbs(name, t, shape)
    dev = x.device
    lib = lib_for(dev)
    scratch = _scratch(dev, lib.fr_fft_scratch_bytes(batch, n))
    out = torch.empty_like(x)
    _build.require_cuda("fr_fft", x, roots, scale, scratch, out)
    _build.check(lib.fr_fft_launch(
        x.data_ptr(), roots.data_ptr(), scale.data_ptr(), batch, n,
        scratch.data_ptr(), out.data_ptr(), _build.stream_ptr(x)), "fr_fft")
    _build.launches["fr_fft"] += 1
    return out
