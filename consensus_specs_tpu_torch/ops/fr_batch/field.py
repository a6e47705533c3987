"""BLS12-381 scalar-field (Fr) arithmetic on limb tensors (counterpart of
`consensus_specs_tpu.ops.fr_batch.PrimeFieldKernel`): the plain PyTorch
versions.

The layout is the JAX package's, so that every function here equals its
JAX counterpart limb for limb: an element is an int32 tensor `(..., 33)`
of signed 12-bit limbs in the Montgomery domain with R = 2**396,
signed-lazy between multiplications (the same representation and budget
as `ops/bls_batch/fq.py` for the base field, with the modulus bound to
the instance).  torch's `>>` on int32 is arithmetic, as JAX's is, and
int32 products wrap alike.

JAX's `lax.scan`s become Python loops.  Where JAX computes both arms of a
select over a host-known bit (`inv`, `pow_uint`), the loop computes only
the arm it keeps, which gives the same limbs.  `canon` (not in JAX) is
the unique canonical form the kernels (`csrc/fr.cuh`) are compared at.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

LIMB_BITS = 12
N_LIMBS = 33
LIMB_MASK = (1 << LIMB_BITS) - 1
R_BITS = LIMB_BITS * N_LIMBS

# BLS12-381 subgroup order (the KZG BLS_MODULUS)
R_MODULUS = 0x73eda753299d7d483339d80809a1d80553bda402fffe5bfeffffffff00000001


@functools.cache
def _const(limbs: bytes, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(
        np.frombuffer(limbs, dtype=np.int32).copy()).to(device)


def const(arr: np.ndarray, device) -> torch.Tensor:
    """A numpy int32 constant as a tensor on `device` (made once)."""
    arr = np.ascontiguousarray(arr, dtype=np.int32)
    return _const(arr.tobytes(), torch.device(device)).view(arr.shape)


def _bits(e: int) -> list[int]:
    return [int(b) for b in bin(e)[2:]]


class PrimeField:
    """Limb arithmetic for an odd prime modulus < 2**300 (JAX
    `PrimeFieldKernel`, `fr_batch.py:48`): host conversions and the
    plain device ops, shapes (..., 33), broadcasting over leading axes."""

    def __init__(self, modulus: int):
        assert modulus % 2 == 1 and modulus.bit_length() <= 300
        self.modulus = modulus
        self.r_mont = pow(2, R_BITS, modulus)
        self.q_inv_neg = (-pow(modulus, -1, 1 << LIMB_BITS)) \
            % (1 << LIMB_BITS)
        self.p_limbs = self.int_to_limbs(modulus)
        self.two_p_limbs = self.int_to_limbs(2 * modulus)
        self.one_mont = self.to_mont(1)
        self._p_minus_2_bits = _bits(modulus - 2)

    # --- host conversions (JAX `:69-104`) ----------------------------------

    def int_to_limbs(self, x: int) -> np.ndarray:
        assert 0 <= x < (1 << R_BITS)
        return np.array([(x >> (LIMB_BITS * i)) & LIMB_MASK
                         for i in range(N_LIMBS)], dtype=np.int32)

    def limbs_to_int(self, limbs) -> int:
        if isinstance(limbs, torch.Tensor):
            limbs = limbs.cpu().numpy()
        arr = np.asarray(limbs).reshape(-1, N_LIMBS)
        assert arr.shape[0] == 1
        return sum(int(v) << (LIMB_BITS * i) for i, v in enumerate(arr[0]))

    def to_mont(self, x: int) -> np.ndarray:
        return self.int_to_limbs((x % self.modulus) * self.r_mont
                                 % self.modulus)

    def to_mont_batch(self, xs) -> np.ndarray:
        """Int batch -> (n, 33) Montgomery limbs: the reduction per
        element, the limb extraction in numpy (bytes -> bits -> 12-bit
        groups), as JAX's."""
        m, r = self.modulus, self.r_mont
        n_bytes = (R_BITS + 7) // 8
        raw = b"".join(((int(x) % m) * r % m).to_bytes(n_bytes, "little")
                       for x in xs)
        as_bytes = np.frombuffer(raw, dtype=np.uint8).reshape(
            len(xs), n_bytes)
        bits = np.unpackbits(as_bytes, axis=1, bitorder="little")
        bits = bits[:, :N_LIMBS * LIMB_BITS].reshape(
            len(xs), N_LIMBS, LIMB_BITS)
        weights = (1 << np.arange(LIMB_BITS)).astype(np.int32)
        return (bits * weights).sum(axis=2).astype(np.int32)

    def from_mont(self, limbs) -> int:
        return (self.limbs_to_int(limbs)
                * pow(self.r_mont, -1, self.modulus)) % self.modulus

    def from_mont_batch(self, limbs) -> list[int]:
        """(..., 33) limbs -> the canonical ints, flattened row-major."""
        if isinstance(limbs, torch.Tensor):
            limbs = limbs.cpu().numpy()
        arr = np.asarray(limbs, dtype=np.int64).reshape(-1, N_LIMBS)
        inv = pow(self.r_mont, -1, self.modulus)
        return [sum(int(v) << (LIMB_BITS * i) for i, v in enumerate(row))
                * inv % self.modulus for row in arr]

    # --- device ops (JAX `:106-197`) --------------------------------------

    def carry(self, x: torch.Tensor, passes: int = 1) -> torch.Tensor:
        """Signed lo/hi carry passes; the top limb absorbs its carry raw."""
        for _ in range(passes):
            hi = x >> LIMB_BITS
            y = x & LIMB_MASK
            y[..., 1:] += hi[..., :-1]
            y[..., -1] = x[..., -1] + hi[..., -2]
            x = y
        return x

    def add(self, a, b):
        return self.carry(a + b)

    def sub(self, a, b):
        return self.carry(a - b)

    def mul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """CIOS Montgomery product ab/R mod p over a's 33 limbs, one carry
        pass per step and one at the end, as JAX's scan.  The shift by a
        limb is a window moving along a zeroed buffer (as `fq.fq_mul`):
        step i works on W[i:i+33] and leaves the shifted state in
        W[i+1:i+34]."""
        shape = torch.broadcast_shapes(a.shape, b.shape)
        a = a.expand(shape)
        b = b.expand(shape).contiguous()
        p = const(self.p_limbs, b.device)
        W = torch.zeros(shape[:-1] + (2 * N_LIMBS + 1,), dtype=torch.int32,
                        device=b.device)
        for i in range(N_LIMBS):
            u = W[..., i:i + N_LIMBS]
            u.addcmul_(a[..., i:i + 1], b)
            m = (u[..., :1] * self.q_inv_neg).bitwise_and_(LIMB_MASK)
            u.addcmul_(m, p)
            t = W[..., i + 1:i + 1 + N_LIMBS]
            t[..., :1] += u[..., :1] >> LIMB_BITS   # u0 = 0 mod 2**12
            hi = t[..., :-1] >> LIMB_BITS
            t[..., :-1] &= LIMB_MASK
            t[..., 1:] += hi
        return self.carry(W[..., N_LIMBS:2 * N_LIMBS].clone())

    def _pow_bits(self, a: torch.Tensor, bits) -> torch.Tensor:
        acc = const(self.one_mont, a.device).expand(a.shape)
        for bit in bits:
            acc = self.mul(acc, acc)
            if bit:
                acc = self.mul(acc, a)
        return acc

    def inv(self, a):
        """Fermat inversion a**(p-2); zero maps to zero."""
        return self._pow_bits(a, self._p_minus_2_bits)

    def pow_uint(self, a, exponent: int):
        """a**exponent for a fixed python-int exponent."""
        return self._pow_bits(a, _bits(exponent))

    def tree_sum(self, x: torch.Tensor, n: int) -> torch.Tensor:
        """Lazy sum over the leading axis, padded to a power of two and
        halved with one carry pass per level (value < n * 2p)."""
        m = 1
        while m < n:
            m *= 2
        if m != n:
            pad = torch.zeros((m - n,) + tuple(x.shape[1:]),
                              dtype=torch.int32, device=x.device)
            x = torch.cat([x, pad])
        while m > 1:
            m //= 2
            x = self.carry(x[:m] + x[m:2 * m])
        return x[0]

    # --- canonical form (the kernels' boundary) ----------------------------

    @staticmethod
    def _normalize(x: torch.Tensor) -> torch.Tensor:
        """Exact carry: limbs 0..31 into [0, 2**12), the top limb signed."""
        while True:
            hi = x[..., :-1] >> LIMB_BITS
            if not hi.any():
                return x
            x = x.clone()
            x[..., :-1] &= LIMB_MASK
            x[..., 1:] += hi

    def canon(self, x: torch.Tensor) -> torch.Tensor:
        """The unique canonical limbs of x's value in [0, p)."""
        x = self.mul(x, const(self.one_mont, x.device))     # (-p, 2p)
        x = self._normalize(x + const(self.two_p_limbs, x.device))
        p = const(self.p_limbs, x.device)
        for _ in range(3):
            d = self._normalize(x - p)
            x = torch.where((d[..., -1] >= 0)[..., None], d, x)
        return x


FR = PrimeField(R_MODULUS)

# batch-shape ladder of the DAS coset interpolation (JAX `fr_batch.py:205`)
_DAS_STEPS = (16, 128, 1024)


def das_rung(n: int) -> int:
    """Padded cell-batch shape for n live statements (JAX `:209`)."""
    b = 1 if n <= 1 else 1 << (n - 1).bit_length()
    for step in _DAS_STEPS:
        if b <= step:
            return step
    return b
