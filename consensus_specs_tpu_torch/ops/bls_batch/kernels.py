"""Wrappers of the BLS kernels K7-K10 (`csrc/bls_rlc.cu`, device arithmetic
in `csrc/bls12_381.cuh`).

Each wrapper takes and returns the port's boundary format (JAX's
(..., 33) int32 limbs, R = 2**396; outputs canonical), checks its inputs,
launches on the current stream, raises on a refused launch and adds one to
its launch count.  It never falls back to a plain version: the plain
versions and the dispatch by device live beside them (`field_op`,
`bls_batch.rlc_scalar_mul` and the stages after it).

The kernels' constants are not typed into the source: `constant_words`
derives them from the port's Python oracle and `_lib` writes them into
the `__constant__` block once per device.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ... import _build
from ..bls import curve as _pycurve
from ..bls.fields import BLS_X, Q, _GAMMA
from . import fq as _fq
from . import tower as tw
from .pairing import JX, JY, SX, SY

N_WORDS = 12            # 32-bit words of a kernel Fp
R_KERNEL = 1 << 384     # the kernels' Montgomery R

# op name -> (code, element dims after the batch, inputs)
FIELD_OPS = {
    "fq_mul": (0, 1, 2), "fq_inv": (1, 1, 1), "fq_canon": (2, 1, 1),
    "fq2_mul": (3, 2, 2), "fq2_inv": (4, 2, 1), "fq12_mul": (5, 4, 2),
    "fq12_sqr": (6, 4, 1), "fq12_inv": (7, 4, 1),
    "fq12_frobenius": (8, 4, 1),
}


def _words(x: int) -> list[int]:
    return [(x >> (32 * i)) & 0xFFFFFFFF for i in range(N_WORDS)]


def _mont_words(x: int) -> list[int]:
    return _words(x % Q * R_KERNEL % Q)


def constant_words() -> np.ndarray:
    """The `BlsConstants` block of `bls12_381.cuh`, in its field order, as
    uint32 words: p, p - 2, the Montgomery one, the boundary conversion
    factors, -p^-1 mod 2^32, the line slots, |x|, the Frobenius gammas
    and the untwist scales (both in the kernels' Montgomery form)."""
    x_abs = abs(BLS_X)
    assert JX not in (0, JY) and JY != 0
    words = (_words(Q) + _words(Q - 2) + _words(R_KERNEL % Q)
             + _words(pow(2, 372, Q)) + _words(pow(2, 756, Q))
             + _words(pow(2, 768, Q)) + _words(pow(2, 396, Q))
             + [(-pow(Q, -1, 1 << 32)) % (1 << 32), JX, JY,
                x_abs >> 32, x_abs & 0xFFFFFFFF])
    for g in list(_GAMMA) + [SX, SY]:
        words += _mont_words(g.c0) + _mont_words(g.c1)
    out = np.array(words, dtype=np.uint32)
    assert out.size == 281
    return out


@functools.cache
def _lib_loaded():
    lib = _build.load("bls_rlc")
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.bls_set_constants.argtypes = [p, i32]
    lib.bls_field_ops_launch.argtypes = [i32, i32, p, p, p, i64, p]
    lib.rlc_scalar_mul_launch.argtypes = [p] * 6 + [i32, i32] + [p] * 7
    lib.rlc_miller_scratch_bytes.argtypes = [i32]
    lib.rlc_miller_scratch_bytes.restype = i64
    lib.rlc_miller_product_launch.argtypes = ([p] * 12 + [i32] + [p] * 4
                                              + [i32, p])
    lib.final_exp_is_one_launch.argtypes = [p, p, p, p]
    for f in ("bls_set_constants", "bls_field_ops_launch", "rlc_scalar_mul_launch",
              "rlc_miller_product_launch", "final_exp_is_one_launch"):
        getattr(lib, f).restype = i32
    return lib


@functools.cache
def _lib(device_index: int):
    """The library, with its constants written on device `device_index`."""
    lib = _lib_loaded()
    words = constant_words()
    with torch.cuda.device(device_index):
        _build.check(lib.bls_set_constants(words.ctypes.data, words.size),
                     "bls_set_constants")
    return lib


def lib_for(device) -> ctypes.CDLL:
    """The library with its constants on `device` (a CUDA device)."""
    dev = torch.device(device)
    return _lib(dev.index if dev.index is not None
                else torch.cuda.current_device())


@functools.cache
def _neg_g1(device: torch.device):
    x, y = _pycurve.g1.to_affine(_pycurve.g1.neg(_pycurve.G1_GEN))
    return (_fq.const(_fq.to_mont(x), device),
            _fq.const(_fq.to_mont(y), device))


def neg_g1_affine(device) -> tuple[torch.Tensor, torch.Tensor]:
    """-G1 in affine limbs, the pairing lane of the signature sum."""
    return _neg_g1(torch.device(device))


def _limbs(name: str, t: torch.Tensor, shape: tuple) -> None:
    if t.dtype != torch.int32 or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected int32 {tuple(shape)}, got "
                         f"{t.dtype} {tuple(t.shape)}")


def _flags(name: str, t: torch.Tensor, n: int) -> None:
    if t.dtype != torch.bool or tuple(t.shape) != (n,):
        raise ValueError(f"{name}: expected bool ({n},), got {t.dtype} "
                         f"{tuple(t.shape)}")


# --- K7 ------------------------------------------------------------------


def field_op_kernel(op: str, a: torch.Tensor, b=None, k: int = 0):
    """K7: `op` elementwise over the batch of `a` (and `b`); canonical
    output of `a`'s shape."""
    if op not in FIELD_OPS:
        raise ValueError(f"unknown field op {op!r}")
    code, dims, n_in = FIELD_OPS[op]
    elem = a.shape[a.dim() - dims:]
    want = {1: (33,), 2: (2, 33), 4: (2, 3, 2, 33)}[dims]
    if a.dtype != torch.int32 or tuple(elem) != want:
        raise ValueError(f"{op}: expected int32 (..., {want}), got "
                         f"{a.dtype} {tuple(a.shape)}")
    a = a.contiguous()
    if n_in == 2:
        if b is None or b.shape != a.shape or b.dtype != torch.int32:
            raise ValueError(f"{op}: b must match a's shape and dtype")
        b = b.contiguous()
    else:
        b = a
    out = torch.empty_like(a)
    _build.require_cuda("bls_field_ops", a, b, out)
    n = a.numel() // int(np.prod(want))
    if n:
        _build.check(lib_for(a.device).bls_field_ops_launch(
            code, int(k), a.data_ptr(), b.data_ptr(), out.data_ptr(), n,
            _build.stream_ptr(a)), "bls_field_ops")
        _build.launches["bls_field_ops"] += 1
    return out


_PLAIN_OPS = {
    "fq_mul": lambda a, b, k: _fq.fq_mul(a, b),
    "fq_inv": lambda a, b, k: _fq.fq_inv(a),
    "fq_canon": lambda a, b, k: a,
    "fq2_mul": lambda a, b, k: tw.fq2_mul(a, b),
    "fq2_inv": lambda a, b, k: tw.fq2_inv(a),
    "fq12_mul": lambda a, b, k: tw.fq12_mul(a, b),
    "fq12_sqr": lambda a, b, k: tw.fq12_sqr(a),
    "fq12_inv": lambda a, b, k: tw.fq12_inv(a),
    "fq12_frobenius": lambda a, b, k: tw.fq12_frobenius(a, k),
}


def field_op_plain(op: str, a, b=None, k: int = 0):
    """K7's plain version: the op in plain PyTorch, then `fq_canon`."""
    return _fq.fq_canon(_PLAIN_OPS[op](a, b, k))


def field_op(op: str, a, b=None, k: int = 0, plain: bool = False):
    """`op` elementwise with canonical output: K7 on a CUDA tensor, the
    plain version otherwise."""
    if a.device.type == "cuda" and not plain:
        return field_op_kernel(op, a, b, k)
    return field_op_plain(op, a, b, k)


# --- K8 ------------------------------------------------------------------


def rlc_scalar_mul_kernel(pk_x, pk_y, sig_x, sig_y, r_bits, mask):
    """K8: (apx, apy, a_inf, (sX, sY, sZ)) for B lanes: r_i PK_i in
    affine with its infinity flag, r_i S_i in Jacobian form with the pad
    lanes (mask False) at infinity; all canonical."""
    B, nbits = r_bits.shape
    for name, t, shape in (("pk_x", pk_x, (B, 33)), ("pk_y", pk_y, (B, 33)),
                           ("sig_x", sig_x, (B, 2, 33)),
                           ("sig_y", sig_y, (B, 2, 33)),
                           ("r_bits", r_bits, (B, nbits))):
        _limbs(name, t, shape)
    _flags("mask", mask, B)
    dev = pk_x.device
    apx = torch.empty((B, 33), dtype=torch.int32, device=dev)
    apy = torch.empty_like(apx)
    a_inf = torch.empty(B, dtype=torch.bool, device=dev)
    sig = tuple(torch.empty((B, 2, 33), dtype=torch.int32, device=dev)
                for _ in range(3))
    args = (pk_x, pk_y, sig_x, sig_y, r_bits, mask, apx, apy, a_inf) + sig
    _build.require_cuda("rlc_scalar_mul", *args)
    if B:
        _build.check(lib_for(pk_x.device).rlc_scalar_mul_launch(
            *(t.data_ptr() for t in args[:6]), nbits, B,
            *(t.data_ptr() for t in args[6:]), _build.stream_ptr(pk_x)),
            "rlc_scalar_mul")
        _build.launches["rlc_scalar_mul"] += 1
    return apx, apy, a_inf, sig


# --- K9 ------------------------------------------------------------------


def rlc_miller_product_kernel(apx, apy, a_inf, r_sig, h_x, h_y, h_ok, mask):
    """K9: the sum of the B signature lanes `r_sig` in affine form
    (sx, sy, s_inf), then the shared-accumulator Miller product over the
    B + 1 lanes (apx, apy | h_x, h_y) and (-G1 | sx, sy), live where
    mask & ~a_inf & h_ok and ~s_inf.  Returns (f, (sx, sy, s_inf)), f an
    Fq12 (2, 3, 2, 33), sx and sy (1, 2, 33), s_inf (1,); canonical."""
    B = apx.shape[0]
    if B < 1:
        raise ValueError("rlc_miller_product: no lanes")
    for name, t, shape in (("apx", apx, (B, 33)), ("apy", apy, (B, 33)),
                           ("sig X", r_sig[0], (B, 2, 33)),
                           ("sig Y", r_sig[1], (B, 2, 33)),
                           ("sig Z", r_sig[2], (B, 2, 33)),
                           ("h_x", h_x, (B, 2, 33)), ("h_y", h_y, (B, 2, 33))):
        _limbs(name, t, shape)
    for name, t in (("a_inf", a_inf), ("h_ok", h_ok), ("mask", mask)):
        _flags(name, t, B)
    dev = apx.device
    g1x, g1y = neg_g1_affine(dev)
    lib = lib_for(apx.device)
    scratch = torch.empty(int(lib.rlc_miller_scratch_bytes(B)),
                          dtype=torch.uint8, device=dev)
    f = torch.empty((2, 3, 2, 33), dtype=torch.int32, device=dev)
    sxy = torch.empty((2, 1, 2, 33), dtype=torch.int32, device=dev)
    s_inf = torch.empty(1, dtype=torch.bool, device=dev)
    args = (apx, apy, a_inf, *r_sig, h_x, h_y, h_ok, mask, g1x, g1y)
    _build.require_cuda("rlc_miller_product", *args, scratch, f, sxy, s_inf)
    threads = min(256, -(-(B + 1) // 32) * 32)
    _build.check(lib.rlc_miller_product_launch(
        *(t.data_ptr() for t in args), B, scratch.data_ptr(), f.data_ptr(),
        sxy.data_ptr(), s_inf.data_ptr(), threads, _build.stream_ptr(apx)),
        "rlc_miller_product")
    _build.launches["rlc_miller_product"] += 1
    return f, (sxy[0], sxy[1], s_inf)


# --- K10 -----------------------------------------------------------------


def final_exp_is_one_kernel(f):
    """K10: (final_exponentiate(f), its fq12_is_one) for one Fq12 f; the
    value canonical, the verdict a (1,) bool tensor."""
    _limbs("f", f, (2, 3, 2, 33))
    f = f.contiguous()
    fe = torch.empty_like(f)
    ok = torch.empty(1, dtype=torch.bool, device=f.device)
    _build.require_cuda("final_exp_is_one", f, fe, ok)
    _build.check(lib_for(f.device).final_exp_is_one_launch(
        f.data_ptr(), fe.data_ptr(), ok.data_ptr(), _build.stream_ptr(f)),
        "final_exp_is_one")
    _build.launches["final_exp_is_one"] += 1
    return fe, ok
