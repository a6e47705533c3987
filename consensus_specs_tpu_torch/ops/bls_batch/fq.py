"""BLS12-381 base-field arithmetic on limb tensors (counterpart of
`consensus_specs_tpu.ops.bls_batch.fq`): the plain PyTorch versions.

The layout is the JAX package's, so that every function here equals its
JAX counterpart limb for limb: an Fq element is an int32 tensor
`(..., 33)` of signed 12-bit limbs in the Montgomery domain with
R = 2**396, "signed-lazy" between multiplications (limbs may be negative,
values range over (-64p, 64p)); every Montgomery product collapses the
magnitude back under 2p, and only `fq_canon` fully normalizes.  torch's
`>>` on int32 is arithmetic, as JAX's is, and int32 products wrap alike.

JAX's `lax.scan`s become Python loops.  Where JAX computes both arms of a
select over a host-known bit (`fq_pow_const`), the loop computes only the
arm it keeps, which gives the same limbs.  `fq_canon` reaches the unique
canonical limbs by vectorized carry passes repeated until no limb
carries, where JAX scans the 33 limbs one by one.

The kernels (`csrc/bls12_381.cuh`) keep their own representation and
take and return this one, canonical, at their boundary.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..bls.fields import Q

LIMB_BITS = 12
N_LIMBS = 33                      # 33 * 12 = 396 bits of capacity
LIMB_MASK = (1 << LIMB_BITS) - 1
R_BITS = LIMB_BITS * N_LIMBS      # Montgomery R = 2**396
R_MONT = pow(2, R_BITS, Q)
# -Q^-1 mod 2**12 (the CIOS per-step multiplier)
Q_INV_NEG = (-pow(Q, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS)


def int_to_limbs(x: int) -> np.ndarray:
    """Python int (non-negative) -> (33,) int32 limb vector."""
    assert 0 <= x < (1 << R_BITS)
    return np.array([(x >> (LIMB_BITS * i)) & LIMB_MASK
                     for i in range(N_LIMBS)], dtype=np.int32)


def limbs_to_int(limbs) -> int:
    """(..., 33) limb vector -> python int (single element; signed limbs)."""
    if isinstance(limbs, torch.Tensor):
        limbs = limbs.cpu().numpy()
    arr = np.asarray(limbs).reshape(-1, N_LIMBS)
    assert arr.shape[0] == 1
    return sum(int(v) << (LIMB_BITS * i) for i, v in enumerate(arr[0]))


def to_mont(x: int) -> np.ndarray:
    """Canonical int -> Montgomery-domain limb vector (host-side)."""
    return int_to_limbs((x % Q) * R_MONT % Q)


def from_mont(limbs) -> int:
    """Montgomery-domain limb vector -> canonical int (host-side)."""
    return limbs_to_int(limbs) * pow(R_MONT, -1, Q) % Q


P_LIMBS = int_to_limbs(Q)
TWO_P_LIMBS = int_to_limbs(2 * Q)
ONE_MONT = to_mont(1)
ONE_PLAIN = int_to_limbs(1)       # fq_mul(a, ONE_PLAIN): out of Montgomery form

# p - 2 bits, MSB first (Fermat inversion exponent)
_P_MINUS_2_BITS = np.array(
    [int(b) for b in bin(Q - 2)[2:]], dtype=np.int32)


@functools.cache
def _const(limbs: bytes, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(
        np.frombuffer(limbs, dtype=np.int32).copy()).to(device)


def const(arr: np.ndarray, device) -> torch.Tensor:
    """A numpy int32 constant as a tensor on `device` (made once)."""
    arr = np.ascontiguousarray(arr, dtype=np.int32)
    return _const(arr.tobytes(), torch.device(device)).view(arr.shape)


def fq_carry(x: torch.Tensor, passes: int = 1) -> torch.Tensor:
    """Redistribute limb overflow: vectorized lo/hi passes with signed
    (arithmetic-shift) carries.  The TOP limb is never split: it absorbs
    the incoming carry raw (JAX `fq.py:85`)."""
    for _ in range(passes):
        hi = x >> LIMB_BITS
        y = x & LIMB_MASK
        y[..., 1:] += hi[..., :-1]
        y[..., -1] = x[..., -1] + hi[..., -2]
        x = y
    return x


def fq_add(a, b):
    return fq_carry(a + b)


def fq_sub(a, b):
    return fq_carry(a - b)


def fq_neg(a):
    return fq_carry(-a)


def fq_mul_small(a, k: int):
    """Multiply by a small python int (|k| <= ~16)."""
    return fq_carry(a * k, passes=2)


def fq_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product ab/R mod p: CIOS over a's 33 limbs, each step
    t += a_i * b;  m = -t0/p mod 2**12;  t = (t + m*p) >> 12, then one
    carry pass, as JAX's scan step (`fq.py:119`) does.  The shift by a
    limb is a window moving one limb along a zeroed buffer: step i works
    on W[i:i+33], and W[i+1:i+34] is the shifted state (its top limb
    still zero), which the step's carry pass then updates in place."""
    shape = torch.broadcast_shapes(a.shape, b.shape)
    a = a.expand(shape)
    b = b.expand(shape).contiguous()
    p = const(P_LIMBS, b.device)
    W = torch.zeros(shape[:-1] + (2 * N_LIMBS + 1,), dtype=torch.int32,
                    device=b.device)
    for i in range(N_LIMBS):
        u = W[..., i:i + N_LIMBS]
        u.addcmul_(a[..., i:i + 1], b)
        m = (u[..., :1] * Q_INV_NEG).bitwise_and_(LIMB_MASK)
        u.addcmul_(m, p)
        t = W[..., i + 1:i + 1 + N_LIMBS]
        t[..., :1] += u[..., :1] >> LIMB_BITS  # u0 = 0 mod 2**12: exact
        hi = t[..., :-1] >> LIMB_BITS
        t[..., :-1] &= LIMB_MASK
        t[..., 1:] += hi
    return fq_carry(W[..., N_LIMBS:2 * N_LIMBS].clone())


def fq_sqr(a):
    return fq_mul(a, a)


def _normalize(x: torch.Tensor) -> torch.Tensor:
    """Exact carry: limbs 0..31 into [0, 2**12), the top limb absorbing
    the rest (signed), the value unchanged.  Passes repeat until no limb
    carries."""
    while True:
        hi = x[..., :-1] >> LIMB_BITS
        if not hi.any():
            return x
        x = x.clone()
        x[..., :-1] &= LIMB_MASK
        x[..., 1:] += hi


def fq_canon(x: torch.Tensor) -> torch.Tensor:
    """Fully reduce to the canonical representative in [0, p), exact limbs
    (JAX `fq.py:151`; the output is unique, so equal to JAX's)."""
    x = fq_mul(x, const(ONE_MONT, x.device))          # into (-2p, 2p)
    x = _normalize(x + const(TWO_P_LIMBS, x.device))  # into (0, 4p)
    p = const(P_LIMBS, x.device)
    for _ in range(3):
        d = _normalize(x - p)
        x = torch.where((d[..., -1] >= 0)[..., None], d, x)
    return x


def fq_eq(a, b):
    return (fq_canon(a) == fq_canon(b)).all(dim=-1)


def fq_is_zero(a):
    return (fq_canon(a) == 0).all(dim=-1)


def fq_pow_const(a: torch.Tensor, bits) -> torch.Tensor:
    """a**e for a fixed exponent given as an MSB-first bit array (host
    constant): square, and multiply where the bit is set."""
    acc = const(ONE_MONT, a.device).expand(a.shape)
    for bit in np.asarray(bits).tolist():
        acc = fq_sqr(acc)
        if bit:
            acc = fq_mul(acc, a)
    return acc


def fq_inv(a):
    """Fermat inversion a**(p-2); zero maps to zero."""
    return fq_pow_const(a, _P_MINUS_2_BITS)
