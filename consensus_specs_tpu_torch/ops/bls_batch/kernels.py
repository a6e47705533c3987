"""Wrappers of the BLS kernels K7-K14, K19, K20 and K25-K27, one shared
library per source: `csrc/bls_rlc.cu` (K7-K10), `bls_h2c.cu` (K11),
`bls_pairing.cu` (K12), `bls_msm.cu` (K13, K14, K27), `g1_fft.cu` (K19,
K20) and `bls_shard.cu` (K25, K26), all over the device arithmetic of
`csrc/bls12_381.cuh`.

Each wrapper takes and returns the port's boundary format (JAX's
(..., 33) int32 limbs, R = 2**396; outputs canonical), checks its inputs,
launches on the current stream, raises on a refused launch and adds one to
its launch count.  It never falls back to a plain version: the plain
versions and the dispatch by device live beside them (`field_op`,
`bls_batch.rlc_scalar_mul` and the other stages).

The kernels' constants are not typed into the source: `constant_words`
(and, for K11, `h2c_constant_words`) derive them from the port's Python
oracle, and `lib_for` writes them into each library's own `__constant__`
block once per device.
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
from . import h2c
from . import tower as tw
from .pairing import JX, JY, SX, SY, X_BITS

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


# Fixed chains: exponents by sliding windows over the odd powers
# a .. a^31 (p - 2 in `BlsConstants.e_inv`, and K11's in `bls_h2c.cu`),
# K11's cofactor by signed windows over the odd multiples q .. 15q
FP_INV_DIGITS = 384
H2C_EXP_WINDOW = 5
H2C_H2_WINDOW = 5
H2C_EXP_DIGITS = 384
H2C_H2_DIGITS = 512


def window_digits(e: int, w: int) -> list[int]:
    """Left-to-right sliding-window digits of e > 0, MSB first:
    e = sum_k d_k 2^(n - 1 - k), each d_k 0 or odd and < 2^w."""
    bits = bin(e)[2:]
    d = [0] * len(bits)
    i = 0
    while i < len(bits):
        if bits[i] == "0":
            i += 1
            continue
        j = min(i + w, len(bits))
        while bits[j - 1] == "0":
            j -= 1
        d[j - 1] = int(bits[i:j], 2)
        i = j
    return d


def signed_window_digits(k: int, w: int) -> list[int]:
    """Width-w NAF of k > 0, MSB first: k = sum_i d_i 2^(n - 1 - i), each
    d_i 0 or odd with |d_i| < 2^(w - 1), the first positive."""
    out = []
    while k:
        d = 0
        if k & 1:
            d = k % (1 << w)
            if d >= 1 << (w - 1):
                d -= 1 << w
            k -= d
        out.append(d)
        k >>= 1
    return out[::-1]


def _digit_words(d: list[int], size: int) -> list[int]:
    b = np.zeros(size, dtype=np.int8)
    b[:len(d)] = d
    return b.view(np.uint32).tolist()


def constant_words() -> np.ndarray:
    """The `BlsConstants` block of `bls12_381.cuh`, in its field order, as
    uint32 words: p, p - 2, the Montgomery one, the boundary conversion
    factors, -p^-1 mod 2^32, the line slots, |x|, the Frobenius gammas
    and the untwist scales (both in the kernels' Montgomery form), and the
    sliding-window digits of p - 2 (int8 in words) with their count."""
    x_abs = abs(BLS_X)
    assert JX not in (0, JY) and JY != 0
    words = (_words(Q) + _words(Q - 2) + _words(R_KERNEL % Q)
             + _words(pow(2, 372, Q)) + _words(pow(2, 756, Q))
             + _words(pow(2, 768, Q)) + _words(pow(2, 396, Q))
             + [(-pow(Q, -1, 1 << 32)) % (1 << 32), JX, JY,
                x_abs >> 32, x_abs & 0xFFFFFFFF])
    for g in list(_GAMMA) + [SX, SY]:
        words += _mont_words(g.c0) + _mont_words(g.c1)
    e_inv = window_digits(Q - 2, H2C_EXP_WINDOW)
    assert len(e_inv) <= FP_INV_DIGITS
    words += _digit_words(e_inv, FP_INV_DIGITS) + [len(e_inv)]
    out = np.array(words, dtype=np.uint32)
    assert out.size == 378
    return out


def h2c_constant_words() -> np.ndarray:
    """The `H2cConstants` block of `bls_h2c.cu`, in its field order, as
    uint32 words: the xmd block templates, the digits of (p - 3) / 4 and
    p - 2 (sliding windows) and of the cofactor H2 (signed windows), as
    int8 in words, their lengths, 1/2, and the SVDW constants c1-c4, Z
    and the twist's B (field elements in the kernels' Montgomery form)."""
    e_sqrt = window_digits((Q - 3) // 4, H2C_EXP_WINDOW)
    e_inv = window_digits(Q - 2, H2C_EXP_WINDOW)
    h2 = signed_window_digits(_pycurve.H2, H2C_H2_WINDOW)
    assert max(len(e_sqrt), len(e_inv)) <= H2C_EXP_DIGITS
    assert len(h2) <= H2C_H2_DIGITS and h2[0] > 0
    words = (h2c._B0_TPL.ravel().tolist()
             + np.stack(h2c._BI_TPLS).ravel().tolist()
             + _digit_words(e_sqrt, H2C_EXP_DIGITS)
             + _digit_words(e_inv, H2C_EXP_DIGITS)
             + _digit_words(h2, H2C_H2_DIGITS)
             + [len(e_sqrt), len(e_inv), len(h2)] + _mont_words(pow(2, -1, Q)))
    sv = h2c._SVDW_G2
    for g in (sv.c1, sv.c2, sv.c3, sv.c4, sv.Z, _pycurve.B2):
        words += _mont_words(g.c0) + _mont_words(g.c1)
    out = np.array(words, dtype=np.uint32)
    assert out.size == 783
    return out


_p, _i32, _i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# library -> {launcher: argtypes}; every launcher returns an int status
_SIGNATURES = {
    "bls_rlc": {
        "bls_field_ops_launch": [_i32, _i32, _p, _p, _p, _i64, _p],
        "rlc_scalar_mul_launch": [_p] * 6 + [_i32, _i32] + [_p] * 7,
        "rlc_miller_product_launch": [_p] * 12 + [_i32] + [_p] * 5,
        "final_exp_is_one_launch": [_p, _p, _p, _p],
    },
    "bls_shard": {
        "rlc_miller_shard_launch": [_p] * 10 + [_i32] + [_p] * 4,
        "rlc_shard_combine_launch": [_p] * 6 + [_i32] + [_p] * 5,
    },
    "bls_h2c": {
        "h2c_set_constants": [_p, _i32],
        "hash_to_g2_launch": [_p, _i32, _p, _p, _p, _p, _p],
    },
    "bls_pairing": {
        "precomp_miller_product_launch": [_p] * 4 + [_i32, _p, _p, _p],
    },
    "bls_msm": {
        "msm_pippenger_launch": [_p] * 3 + [_i32] * 3 + [_p] * 3,
        "msm_double_add_launch": [_p] * 4 + [_i32] * 2 + [_p] * 3,
        "g1_shard_fold_launch": [_p] * 3 + [_i32] + [_p] * 3,
    },
    "g1_fft": {
        "g1_fft_launch": [_p] * 3 + [_i32] * 3 + [_p] * 4 + [_i32]
        + [_p] * 3,
        "fk20_hext_launch": [_p] * 4 + [_i32] * 2 + [_p] * 2,
    },
}
# scratch-size functions: name -> argument count (all int)
_SCRATCH = {"rlc_miller_scratch_bytes": 1, "h2c_scratch_bytes": 1,
            "precomp_miller_scratch_bytes": 1,
            "msm_pippenger_scratch_bytes": 3,
            "msm_double_add_scratch_bytes": 1, "g1_fft_scratch_bytes": 2,
            "rlc_shard_scratch_bytes": 1, "rlc_combine_scratch_bytes": 1,
            "g1_shard_fold_scratch_bytes": 1}


@functools.cache
def _lib_loaded(name: str):
    lib = _build.load(name)
    lib.bls_set_constants.argtypes = [_p, _i32]
    lib.bls_set_constants.restype = _i32
    for f, args in _SIGNATURES[name].items():
        getattr(lib, f).argtypes = args
        getattr(lib, f).restype = _i32
    for f, n in _SCRATCH.items():
        if hasattr(lib, f):
            getattr(lib, f).argtypes = [_i32] * n
            getattr(lib, f).restype = _i64
    return lib


@functools.cache
def _lib(name: str, device_index: int):
    """Library `name`, with its constants written on device
    `device_index`."""
    lib = _lib_loaded(name)
    with torch.cuda.device(device_index):
        words = constant_words()
        _build.check(lib.bls_set_constants(words.ctypes.data, words.size),
                     f"{name} bls_set_constants")
        if name == "bls_h2c":
            words = h2c_constant_words()
            _build.check(lib.h2c_set_constants(words.ctypes.data,
                                               words.size),
                         "h2c_set_constants")
    return lib


def lib_for(device, name: str = "bls_rlc") -> ctypes.CDLL:
    """Library `name` with its constants on `device` (a CUDA device)."""
    dev = torch.device(device)
    return _lib(name, dev.index if dev.index is not None
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
    _build.check(lib.rlc_miller_product_launch(
        *(t.data_ptr() for t in args), B, scratch.data_ptr(), f.data_ptr(),
        sxy.data_ptr(), s_inf.data_ptr(), _build.stream_ptr(apx)),
        "rlc_miller_product")
    _build.launches["rlc_miller_product"] += 1
    return f, (sxy[0], sxy[1], s_inf)


# --- K25 and K26 ------------------------------------------------------------


def _g2_rows(name: str, pts, n: int) -> None:
    for c, t in zip("XYZ", pts):
        _limbs(f"{name} {c}", t, (n, 2, 33))


def rlc_miller_shard_kernel(apx, apy, a_inf, r_sig, h_x, h_y, h_ok, mask):
    """K25: K9 on one shard's B lanes without the shared (-G1, sum) lane.
    Returns (f, (sX, sY, sZ)): the conjugated Miller product over the
    lanes live where mask & ~a_inf & h_ok, an Fq12 (2, 3, 2, 33), and the
    Jacobian sum of the signature lanes `r_sig`, each (2, 33); all
    canonical."""
    B = apx.shape[0]
    if B < 1:
        raise ValueError("rlc_miller_shard: no lanes")
    for name, t, shape in (("apx", apx, (B, 33)), ("apy", apy, (B, 33)),
                           ("h_x", h_x, (B, 2, 33)), ("h_y", h_y, (B, 2, 33))):
        _limbs(name, t, shape)
    _g2_rows("sig", r_sig, B)
    for name, t in (("a_inf", a_inf), ("h_ok", h_ok), ("mask", mask)):
        _flags(name, t, B)
    dev = apx.device
    lib = lib_for(dev, "bls_shard")
    scratch = torch.empty(int(lib.rlc_shard_scratch_bytes(B)),
                          dtype=torch.uint8, device=dev)
    f = torch.empty((2, 3, 2, 33), dtype=torch.int32, device=dev)
    total = torch.empty((3, 2, 33), dtype=torch.int32, device=dev)
    args = (apx, apy, a_inf, *r_sig, h_x, h_y, h_ok, mask)
    _build.require_cuda("rlc_miller_shard", *args, scratch, f, total)
    _build.check(lib.rlc_miller_shard_launch(
        *(t.data_ptr() for t in args), B, scratch.data_ptr(), f.data_ptr(),
        total.data_ptr(), _build.stream_ptr(apx)),
        "rlc_miller_shard")
    _build.launches["rlc_miller_shard"] += 1
    return f, tuple(total)


def rlc_shard_combine_kernel(sums, fs):
    """K26: from the D shards' Jacobian G2 signature sums `sums` ((sX, sY,
    sZ), each (D, 2, 33)) and Miller products `fs` ((D, 2, 3, 2, 33)):
    their G2 sum in affine form, the Miller loop of the lane (-G1, sum),
    and f = (product of the D partials) times that lane, for K10.
    Returns (f, (sx, sy, s_inf)) as K9 does; canonical."""
    D = fs.shape[0]
    if D < 1:
        raise ValueError("rlc_shard_combine: no partials")
    _g2_rows("sums", sums, D)
    _limbs("fs", fs, (D, 2, 3, 2, 33))
    dev = fs.device
    g1x, g1y = neg_g1_affine(dev)
    lib = lib_for(dev, "bls_shard")
    scratch = torch.empty(int(lib.rlc_combine_scratch_bytes(D)),
                          dtype=torch.uint8, device=dev)
    f = torch.empty((2, 3, 2, 33), dtype=torch.int32, device=dev)
    sxy = torch.empty((2, 1, 2, 33), dtype=torch.int32, device=dev)
    s_inf = torch.empty(1, dtype=torch.bool, device=dev)
    args = (*sums, fs, g1x, g1y)
    _build.require_cuda("rlc_shard_combine", *args, scratch, f, sxy, s_inf)
    _build.check(lib.rlc_shard_combine_launch(
        *(t.data_ptr() for t in args), D, scratch.data_ptr(), f.data_ptr(),
        sxy.data_ptr(), s_inf.data_ptr(), _build.stream_ptr(fs)),
        "rlc_shard_combine")
    _build.launches["rlc_shard_combine"] += 1
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


# --- K11 -----------------------------------------------------------------


def hash_to_g2_kernel(msg_words):
    """K11: (h_x, h_y, h_ok) for B 32-byte messages given as (B, 8) int32
    big-endian word bit patterns: H(m) in affine form, (B, 2, 33)
    canonical, and ~infinity (B,)."""
    B = msg_words.shape[0]
    _limbs("msg_words", msg_words, (B, 8))
    dev = msg_words.device
    lib = lib_for(dev, "bls_h2c")
    scratch = torch.empty(max(1, int(lib.h2c_scratch_bytes(B))),
                          dtype=torch.uint8, device=dev)
    h_x = torch.empty((B, 2, 33), dtype=torch.int32, device=dev)
    h_y = torch.empty_like(h_x)
    h_ok = torch.empty(B, dtype=torch.bool, device=dev)
    _build.require_cuda("hash_to_g2", msg_words, scratch, h_x, h_y, h_ok)
    if B:
        _build.check(lib.hash_to_g2_launch(
            msg_words.data_ptr(), B, scratch.data_ptr(), h_x.data_ptr(),
            h_y.data_ptr(), h_ok.data_ptr(), _build.stream_ptr(msg_words)),
            "hash_to_g2")
        _build.launches["hash_to_g2"] += 1
    return h_x, h_y, h_ok


# --- K12 -----------------------------------------------------------------


def precomp_miller_product_kernel(xp, yp, lines, mask):
    """K12: the Miller product over host-precomputed lines (n_bits, B, 6,
    2, 33) at the B affine G1 points (xp, yp), lanes live where `mask`;
    one conjugated Fq12 (2, 3, 2, 33), canonical.  Three launches (the
    lines at P, the live lanes, the fold), counted as one call."""
    B = xp.shape[0]
    if B < 1:
        raise ValueError("precomp_miller_product: no lanes")
    n_bits = len(X_BITS)
    for name, t, shape in (("xp", xp, (B, 33)), ("yp", yp, (B, 33)),
                           ("lines", lines, (n_bits, B, 6, 2, 33))):
        _limbs(name, t, shape)
    _flags("mask", mask, B)
    dev = xp.device
    lib = lib_for(dev, "bls_pairing")
    scratch = torch.empty(int(lib.precomp_miller_scratch_bytes(B)),
                          dtype=torch.uint8, device=dev)
    f = torch.empty((2, 3, 2, 33), dtype=torch.int32, device=dev)
    _build.require_cuda("precomp_miller_product", xp, yp, lines, mask,
                        scratch, f)
    _build.check(lib.precomp_miller_product_launch(
        xp.data_ptr(), yp.data_ptr(), lines.data_ptr(), mask.data_ptr(), B,
        scratch.data_ptr(), f.data_ptr(), _build.stream_ptr(xp)),
        "precomp_miller_product")
    _build.launches["precomp_miller_product"] += 1
    return f


# --- K13 and K14 -----------------------------------------------------------


def msm_pippenger_kernel(x, y, digits, c: int):
    """K13: sum_i k_i P_i by Pippenger's buckets, c-bit windows (digits
    (B, W), most significant first); one Jacobian point (X, Y, Z), each
    (33,) canonical."""
    B, W = digits.shape
    if not 1 <= c <= 16 or W != -(-255 // c) or W > 64:
        raise ValueError(f"msm_pippenger: window {c} with {W} windows")
    for name, t, shape in (("x", x, (B, 33)), ("y", y, (B, 33)),
                           ("digits", digits, (B, W))):
        _limbs(name, t, shape)
    dev = x.device
    lib = lib_for(dev, "bls_msm")
    scratch = torch.empty(int(lib.msm_pippenger_scratch_bytes(B, W, c)),
                          dtype=torch.uint8, device=dev)
    out = torch.empty((3, 33), dtype=torch.int32, device=dev)
    _build.require_cuda("msm_pippenger", x, y, digits, scratch, out)
    _build.check(lib.msm_pippenger_launch(
        x.data_ptr(), y.data_ptr(), digits.data_ptr(), B, W, c,
        scratch.data_ptr(), out.data_ptr(), _build.stream_ptr(x)),
        "msm_pippenger")
    _build.launches["msm_pippenger"] += 1
    return tuple(out)


def msm_double_add_kernel(x, y, bits, mask):
    """K14: sum_i k_i P_i by a double-and-add over each lane's bits (B,
    nbits) MSB first, the lanes where `mask` is False dropped, then the
    tree sum; B a power of two.  One Jacobian point (X, Y, Z), each
    (33,) canonical."""
    B, nbits = bits.shape
    if B < 1 or B & (B - 1):
        raise ValueError(f"msm_double_add: {B} lanes, not a power of two")
    for name, t, shape in (("x", x, (B, 33)), ("y", y, (B, 33)),
                           ("bits", bits, (B, nbits))):
        _limbs(name, t, shape)
    _flags("mask", mask, B)
    dev = x.device
    lib = lib_for(dev, "bls_msm")
    scratch = torch.empty(int(lib.msm_double_add_scratch_bytes(B)),
                          dtype=torch.uint8, device=dev)
    out = torch.empty((3, 33), dtype=torch.int32, device=dev)
    _build.require_cuda("msm_double_add", x, y, bits, mask, scratch, out)
    _build.check(lib.msm_double_add_launch(
        x.data_ptr(), y.data_ptr(), bits.data_ptr(), mask.data_ptr(), nbits,
        B, scratch.data_ptr(), out.data_ptr(), _build.stream_ptr(x)),
        "msm_double_add")
    _build.launches["msm_double_add"] += 1
    return tuple(out)


def g1_shard_fold_kernel(x, y, z):
    """K27: the sum of D Jacobian G1 points (x, y, z, each (D, 33)) in
    pt_sum's tree; one point (X, Y, Z), each (33,) canonical."""
    D = x.shape[0]
    if D < 1:
        raise ValueError("g1_shard_fold: no partials")
    for name, t in (("x", x), ("y", y), ("z", z)):
        _limbs(name, t, (D, 33))
    dev = x.device
    lib = lib_for(dev, "bls_msm")
    scratch = torch.empty(int(lib.g1_shard_fold_scratch_bytes(D)),
                          dtype=torch.uint8, device=dev)
    out = torch.empty((3, 33), dtype=torch.int32, device=dev)
    _build.require_cuda("g1_shard_fold", x, y, z, scratch, out)
    _build.check(lib.g1_shard_fold_launch(
        x.data_ptr(), y.data_ptr(), z.data_ptr(), D, scratch.data_ptr(),
        out.data_ptr(), _build.stream_ptr(x)), "g1_shard_fold")
    _build.launches["g1_shard_fold"] += 1
    return tuple(out)


# --- K19 and K20 -------------------------------------------------------------


def g1_fft_kernel(x, y, z, u_idx, v_idx, digits, inv_bits):
    """K19: the G1 FFT of each row of the Jacobian points (x, y, z), each
    (B, n, 33) in bit-reversed order: the butterfly rounds of the plan
    (u_idx, v_idx (rounds, n/2) int32; digits (rounds, n/2, 64) int32
    twiddle windows, most significant first), then, if `inv_bits`
    ((nbits,) int32, most significant first) is not empty, the fixed
    scalar multiply by it.  Natural-order (X, Y, Z), each (B, n, 33)
    canonical."""
    B, n = x.shape[0], x.shape[1]
    if B < 1 or n < 2 or n & (n - 1):
        raise ValueError(f"g1_fft: batch {B}, n {n}")
    rounds = n.bit_length() - 1
    for name, t, shape in (("x", x, (B, n, 33)), ("y", y, (B, n, 33)),
                           ("z", z, (B, n, 33)),
                           ("u_idx", u_idx, (rounds, n // 2)),
                           ("v_idx", v_idx, (rounds, n // 2)),
                           ("digits", digits, (rounds, n // 2, 64))):
        _limbs(name, t, shape)
    if inv_bits.dtype != torch.int32 or inv_bits.dim() != 1:
        raise ValueError("g1_fft: inv_bits must be int32 (nbits,)")
    dev = x.device
    lib = lib_for(dev, "g1_fft")
    scratch = torch.empty(int(lib.g1_fft_scratch_bytes(B, n)),
                          dtype=torch.uint8, device=dev)
    out = torch.empty((3, B, n, 33), dtype=torch.int32, device=dev)
    bits = inv_bits if inv_bits.numel() else digits
    _build.require_cuda("g1_fft", x, y, z, u_idx, v_idx, digits, bits,
                        scratch, out)
    _build.check(lib.g1_fft_launch(
        x.data_ptr(), y.data_ptr(), z.data_ptr(), B, n, rounds,
        u_idx.data_ptr(), v_idx.data_ptr(), digits.data_ptr(),
        bits.data_ptr(), inv_bits.numel(), scratch.data_ptr(),
        out.data_ptr(), _build.stream_ptr(x)), "g1_fft")
    _build.launches["g1_fft"] += 1
    return tuple(out)


def fk20_hext_kernel(x, y, z, digits):
    """K20: for each of the `width` positions j, sum_c k[c, j] X[c, j] by
    window-4 Pippenger over the R residue rows: points (x, y, z), each
    (R, width, 33) Jacobian, R <= 128; digits (R, width, 64), most
    significant first.  (X, Y, Z), each (width, 33) canonical."""
    R, width = x.shape[0], x.shape[1]
    if not 1 <= R <= 128 or width < 1:
        raise ValueError(f"fk20_hext: {R} residues, width {width}")
    for name, t, shape in (("x", x, (R, width, 33)), ("y", y, (R, width, 33)),
                           ("z", z, (R, width, 33)),
                           ("digits", digits, (R, width, 64))):
        _limbs(name, t, shape)
    dev = x.device
    lib = lib_for(dev, "g1_fft")
    out = torch.empty((3, width, 33), dtype=torch.int32, device=dev)
    _build.require_cuda("fk20_hext", x, y, z, digits, out)
    _build.check(lib.fk20_hext_launch(
        x.data_ptr(), y.data_ptr(), z.data_ptr(), digits.data_ptr(), R,
        width, out.data_ptr(), _build.stream_ptr(x)), "fk20_hext")
    _build.launches["fk20_hext"] += 1
    return tuple(out)
