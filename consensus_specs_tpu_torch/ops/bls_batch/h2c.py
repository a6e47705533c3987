"""Batched hash-to-G2 (counterpart of
`consensus_specs_tpu.ops.bls_batch.h2c_jax`): the plain PyTorch versions.

RFC 9380's random-oracle hash of 32-byte message roots to G2, as JAX
composes it, limb for limb:

  expand_message_xmd  SHA-256 compressions (`ops/sha256.py` `_compress`)
                      over host-templated blocks: only the message words
                      and the chained digests are data;
  hash_to_field       each 512-bit draw into Montgomery Fq limbs by two
                      constant products (u = a + b * 2^396);
  map_to_curve        the oracle's Shallue-van de Woestijne straight line
                      (`ops/bls/hash_to_curve.py`), branchless: all three
                      x-candidates and their Fq2 square roots, selected
                      in the oracle's priority order;
  clear_cofactor      double-and-add by the G2 cofactor H2
                      (`curve.pt_scalar_mul_const`).

The constants are derived from the port's own oracle at import.  Kernel
K11 (`csrc/bls_h2c.cu`, wrapper `kernels.hash_to_g2_kernel`) computes the
same points; `bls_batch.hash_to_g2_affine` dispatches between the two.
"""

from __future__ import annotations

import numpy as np
import torch

from ..._uint import i32_to_u32, u32_to_i32
from ..bls import curve as _pycurve
from ..bls.fields import Q
from ..bls.hash_to_curve import DST_G2, _SVDW_G2
from ..sha256 import _IV, _compress
from . import curve as C
from . import fq as _fq
from . import tower as tw

# --- host-side templates and constants --------------------------------------

MSG_BYTES = 32                    # consensus signing roots are 32 bytes
_L = 64                           # bytes per hash_to_field draw
_COUNT = 2                        # two Fq2 elements (random-oracle map)
_LEN_IN_BYTES = _COUNT * 2 * _L   # 256
_ELL = _LEN_IN_BYTES // 32        # sha256 draws
_DST_PRIME = DST_G2 + bytes([len(DST_G2)])


def _pad_sha(data: bytes) -> bytes:
    """Append SHA-256 Merkle-Damgard padding (length must be static)."""
    rem = (len(data) + 9) % 64
    zeros = (64 - rem) % 64
    return (data + b"\x80" + b"\x00" * zeros
            + (len(data) * 8).to_bytes(8, "big"))


def _words(data: bytes) -> np.ndarray:
    """Padded byte string -> (n_blocks, 16) big-endian uint32 words."""
    return np.frombuffer(data, dtype=">u4").astype(np.uint32).reshape(-1, 16)


# b0 input: Z_pad(64) || msg(32) || len(2) || 0x00 || DST' -- the message
# occupies exactly words 0..8 of block 1
_B0_TPL = _words(_pad_sha(
    b"\x00" * 64 + b"\x00" * MSG_BYTES
    + _LEN_IN_BYTES.to_bytes(2, "big") + b"\x00" + _DST_PRIME))
# b_i inputs: digest(32) || i(1) || DST' -- digest is words 0..8 of block 0
_BI_TPLS = [_words(_pad_sha(b"\x00" * 32 + bytes([i]) + _DST_PRIME))
            for i in range(1, _ELL + 1)]

# Montgomery folding constants for the 512-bit draw u = a + b*2^396:
# mont_mul(a, 2^792) = a*2^396 = a*R and mont_mul(b, 2^1188) = b*2^396*R
_C_LO = _fq.int_to_limbs(pow(2, 2 * _fq.R_BITS, Q))
_C_HI = _fq.int_to_limbs(pow(2, 3 * _fq.R_BITS, Q))

# (Q+1)/4 bits, MSB first: the q = 3 mod 4 square-root exponent
_P14_BITS = np.array([int(b) for b in bin((Q + 1) // 4)[2:]], dtype=np.int32)
_INV2_MONT = _fq.to_mont(pow(2, -1, Q))

# SVDW constants, derived by the port's oracle at import
_C1_L = tw.fq2_from_oracle(_SVDW_G2.c1)
_C2_L = tw.fq2_from_oracle(_SVDW_G2.c2)
_C3_L = tw.fq2_from_oracle(_SVDW_G2.c3)
_C4_L = tw.fq2_from_oracle(_SVDW_G2.c4)
_Z_L = tw.fq2_from_oracle(_SVDW_G2.Z)
_B2_L = tw.fq2_from_oracle(_pycurve.B2)

# G2 cofactor bits, MSB first (derived in ops/bls/curve.py)
_H2_BITS = np.array([int(b) for b in bin(_pycurve.H2)[2:]], dtype=np.int32)


def msgs_to_words(msgs) -> np.ndarray:
    """32-byte messages -> (B, 8) big-endian uint32 word matrix."""
    out = []
    for m in msgs:
        m = bytes(m)
        assert len(m) == MSG_BYTES, "device h2c is fixed to 32-byte roots"
        out.append(np.frombuffer(m, dtype=">u4"))
    return np.stack(out).astype(np.uint32)


def _const(a, like: torch.Tensor) -> torch.Tensor:
    return _fq.const(a, like.device).expand(like.shape)


# --- expand_message_xmd ------------------------------------------------------


def _sha_blocks(blocks):
    """SHA-256 over a fixed block sequence; a block is 16 lanes, each a
    (B,) int64 tensor of uint32 values or a Python int shared by every
    message (the template words)."""
    state = list(_IV)
    for blk in blocks:
        state = _compress(state, blk)
    return state


def expand_message_xmd_dev(msg_words: torch.Tensor) -> torch.Tensor:
    """RFC 9380 §5.3 expand_message_xmd(SHA-256) for fixed 32-byte
    messages and the module DST: (B, 8) int32 word bit patterns ->
    (B, 64) int32 words (256 uniform bytes)."""
    msg = i32_to_u32(msg_words)
    tpl = [[int(w) for w in row] for row in _B0_TPL]
    b0 = _sha_blocks([tpl[0], [msg[:, i] for i in range(8)] + tpl[1][8:],
                      tpl[2]])
    outs, bi = [], None
    for i in range(_ELL):
        first = b0 if i == 0 else [a ^ b for a, b in zip(b0, bi)]
        rows = [[int(w) for w in row] for row in _BI_TPLS[i]]
        bi = _sha_blocks([first + rows[0][8:]] + rows[1:])
        outs += bi
    return u32_to_i32(torch.stack(outs, dim=-1))


# --- hash_to_field -----------------------------------------------------------


def _words512_to_fq_mont(chunk: torch.Tensor) -> torch.Tensor:
    """(..., 16) int32 big-endian words of one 512-bit draw -> Montgomery
    Fq limbs of (value mod Q): 12-bit limb extraction by static shifts,
    then the two-constant Montgomery fold."""
    lw = i32_to_u32(chunk).flip(-1)         # little-endian word order
    limbs = []
    for j in range((16 * 32 + 11) // 12):
        lo = 12 * j
        t0, off = divmod(lo, 32)
        v = lw[..., t0] >> off
        if off > 20 and t0 + 1 < 16:
            v = v | (lw[..., t0 + 1] << (32 - off))
        limbs.append(v & 0xFFF)
    x = torch.stack(limbs, dim=-1).to(torch.int32)
    n = _fq.N_LIMBS
    hi = torch.zeros_like(x[..., :n])
    hi[..., :x.shape[-1] - n] = x[..., n:]
    prod = _fq.fq_mul(torch.stack([x[..., :n], hi]),
                      torch.stack([_const(_C_LO, hi), _const(_C_HI, hi)]))
    return _fq.fq_add(prod[0], prod[1])


def hash_to_field_fq2_dev(msg_words: torch.Tensor):
    """RFC 9380 §5.2 hash_to_field, count=2: (B, 8) message words ->
    (u0, u1) each (B, 2, 33) Montgomery Fq2 limbs."""
    uniform = expand_message_xmd_dev(msg_words)        # (B, 64) words
    els = _words512_to_fq_mont(uniform.reshape(-1, 2 * _COUNT, 16))
    return els[:, 0:2], els[:, 2:4]


# --- branchless Fq2 square root / sgn0 --------------------------------------


def fq2_sqrt_dev(a: torch.Tensor):
    """Batched Fq2 square root with the oracle's exact branch priority
    (`fields.py` Fq2.sqrt), branchless (JAX `h2c_jax.py:198`).  Returns
    (root, is_square); root is garbage where is_square is False."""
    x, y = a[..., 0, :], a[..., 1, :]
    sq = _fq.fq_mul(torch.stack([x, y]), torch.stack([x, y]))
    norm = _fq.fq_add(sq[0], sq[1])

    # phase 1: candidate roots of norm, x, and -x in one stacked scan
    ph1 = _fq.fq_pow_const(torch.stack([norm, x, _fq.fq_neg(x)]), _P14_BITS)
    n, rx, rnx = ph1[0], ph1[1], ph1[2]

    # phase 2: c+- = sqrt((x +- n)/2) candidates, one stacked scan
    inv2 = _fq.const(_INV2_MONT, a.device)
    ts = _fq.fq_mul(torch.stack([_fq.fq_add(x, n), _fq.fq_sub(x, n)]), inv2)
    cs = _fq.fq_pow_const(ts, _P14_BITS)
    wy = _fq.fq_mul(_fq.fq_inv(_fq.fq_mul_small(cs, 2)), y[None])

    zero = torch.zeros_like(x)
    cands = torch.stack([
        torch.stack([rx, zero], dim=-2),      # y == 0, x a QR
        torch.stack([zero, rnx], dim=-2),     # y == 0, x a non-QR
        torch.stack([cs[0], wy[0]], dim=-2),  # general, + sign
        torch.stack([cs[1], wy[1]], dim=-2),  # general, - sign
    ])
    ok = tw.fq2_eq(tw.fq2_sqr(cands), a[None])
    y_zero = _fq.fq_is_zero(y)

    def e(m):
        return m[..., None, None]

    gen = torch.where(e(ok[2]), cands[2], cands[3])
    yz = torch.where(e(ok[0]), cands[0], cands[1])
    root = torch.where(e(y_zero), yz, gen)
    is_sq = torch.where(y_zero, ok[0] | ok[1], ok[2] | ok[3])
    return root, is_sq


def sgn0_fq2_dev(a: torch.Tensor) -> torch.Tensor:
    """RFC 9380 sgn0 for Montgomery Fq2 limbs: out of the Montgomery
    domain (a product by the plain one), canonical, lexicographic
    parity."""
    plain = _fq.fq_canon(_fq.fq_mul(
        torch.stack([a[..., 0, :], a[..., 1, :]]),
        _fq.const(_fq.ONE_PLAIN, a.device)))
    s0 = (plain[0][..., 0] & 1) == 1
    z0 = (plain[0] == 0).all(dim=-1)
    s1 = (plain[1][..., 0] & 1) == 1
    return s0 | (z0 & s1)


# --- Shallue-van de Woestijne map -------------------------------------------


def svdw_map_g2_dev(u: torch.Tensor):
    """RFC 9380 §6.6.1 straight line on (..., 2, 33) Fq2 limbs -> affine
    (x, y) on the twist, bit-identical to the oracle map."""
    one = _const(tw.FQ2_ONE_L, u)
    tv1 = tw.fq2_mul(tw.fq2_sqr(u), _const(_C1_L, u))
    tv2 = tw.fq2_add(one, tv1)
    tv1 = tw.fq2_sub(one, tv1)
    tv3 = tw.fq2_inv(tw.fq2_mul(tv1, tv2))           # inv0: 0 -> 0
    tv4 = tw.fq2_mul(tw.fq2_mul(u, tv1),
                     tw.fq2_mul(tv3, _const(_C3_L, u)))
    x1 = tw.fq2_sub(_const(_C2_L, u), tv4)
    x2 = tw.fq2_add(_const(_C2_L, u), tv4)
    t = tw.fq2_sqr(tw.fq2_mul(tw.fq2_sqr(tv2), tv3))
    x3 = tw.fq2_add(tw.fq2_mul(t, _const(_C4_L, u)), _const(_Z_L, u))

    xs = torch.stack([x1, x2, x3])
    gx = tw.fq2_add(tw.fq2_mul(tw.fq2_sqr(xs), xs), _const(_B2_L, xs))
    roots, ok = fq2_sqrt_dev(gx)

    def e(m):
        return m[..., None, None]

    x = torch.where(e(ok[0]), x1, torch.where(e(ok[1]), x2, x3))
    y = torch.where(e(ok[0]), roots[0],
                    torch.where(e(ok[1]), roots[1], roots[2]))
    flip = sgn0_fq2_dev(u) != sgn0_fq2_dev(y)
    y = torch.where(e(flip), tw.fq2_neg(y), y)
    return x, y


# --- hash_to_curve -----------------------------------------------------------


def hash_to_g2_dev(msg_words: torch.Tensor):
    """hash_to_g2 (random-oracle construction): (B, 8) message words ->
    batched Jacobian G2 point (X, Y, Z), the oracle's
    `ops/bls/hash_to_curve.py` `hash_to_g2` as a point (same DST, map and
    cofactor)."""
    B = msg_words.shape[0]
    u0, u1 = hash_to_field_fq2_dev(msg_words)
    mx, my = svdw_map_g2_dev(torch.cat([u0, u1]))
    one2 = _fq.const(tw.FQ2_ONE_L, msg_words.device).expand(
        (B, 2, _fq.N_LIMBS))
    q = C.pt_add(C.F2, (mx[:B], my[:B], one2), (mx[B:], my[B:], one2))
    return C.pt_scalar_mul_const(C.F2, q, _H2_BITS)
