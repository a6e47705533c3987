"""Batched BLS verification on the card (counterpart of
`consensus_specs_tpu.ops.bls_batch`): the random-linear-combination (RLC)
batch verify of FastAggregateVerify statements, with the messages hashed
to G2 on the host.

`batch_verify(tasks, rng, device="cuda")` checks B statements
e(PK_i, H(m_i)) == e(G1, S_i) at once: with r_0 = 1 and the other r_i
random odd 128-bit values, it accepts iff
    prod_i e(r_i PK_i, H_i) · e(-G1, sum_i r_i S_i) == 1,
B + 1 pairings through one shared Fq12 Miller accumulator and ONE final
exponentiation (JAX's docstring gives the 2^-127 soundness argument).
The host parses, hashes and packs (`_prepare_rlc_inputs`); the device
runs three stages, each a kernel on a CUDA tensor and its plain PyTorch
version on a CPU tensor (or with `plain=True`):

    rlc_scalar_mul      K8   r_i PK_i to affine, r_i S_i (pad lanes inf)
    rlc_miller_product  K9   the G2 sum to affine, the Miller product
    final_exp_is_one    K10  the final exponentiation and the verdict

The plain stages compose exactly as JAX's `_rlc_pairing_core` (:280), so
on the CPU every intermediate equals JAX's limb for limb; the kernels
return canonical limbs, equal to `fq_canon` of the plain ones.  No stage
falls back to another route when a kernel fails to build or launch.

Device hash-to-curve (`_rlc_kernel_h2c`, `device_h2c=True`), the sharded
batch, the MSM and the precomputed-line `pairing_check_device` are not
ported yet: they come with the next slices.  Nothing here is timed,
faulted or telemetered.
"""

from __future__ import annotations

import secrets

import numpy as np
import torch

from ... import resolve_device
from ..bls import curve as _pycurve
from ..bls.hash_to_curve import DST_G2, hash_to_g2
from . import curve as C
from . import fq as _fq
from . import kernels as K
from . import pairing as pj
from . import tower as tw

RLC_SCALAR_BITS = 128     # soundness 2^-127 per forged batch (odd draws)

# batch-shape ladder (JAX `ops/bls_batch/__init__.py:91`)
_BUCKET_STEPS = (8, 32, 128, 512)


def _bucket(n: int) -> int:
    """Padded batch shape for n live lanes: the next power of two,
    quantized UP to the 4-step ladder; n <= 1 maps to the bottom rung."""
    b = 1 if n <= 1 else 1 << (n - 1).bit_length()
    for step in _BUCKET_STEPS:
        if b <= step:
            return step
    return b


# --- device helpers (plain) ---------------------------------------------------


def g1_to_affine_dev(p):
    """Batched Jacobian -> affine; returns (x, y, inf_mask)."""
    X, Y, Z = p
    inf = _fq.fq_is_zero(Z)
    zi = _fq.fq_inv(Z)
    zi2 = _fq.fq_sqr(zi)
    return _fq.fq_mul(X, zi2), _fq.fq_mul(Y, _fq.fq_mul(zi2, zi)), inf


def g2_to_affine_dev(p):
    X, Y, Z = p
    inf = tw.fq2_is_zero(Z)
    zi = tw.fq2_inv(Z)
    zi2 = tw.fq2_sqr(zi)
    return tw.fq2_mul(X, zi2), tw.fq2_mul(Y, tw.fq2_mul(zi2, zi)), inf


def _use_kernel(t: torch.Tensor, plain: bool) -> bool:
    return t.device.type == "cuda" and not plain


# --- the three stages ---------------------------------------------------------


def rlc_scalar_mul_plain(pk_x, pk_y, sig_x, sig_y, r_bits, mask):
    one1 = _fq.const(_fq.ONE_MONT, pk_x.device).expand(pk_x.shape)
    one2 = _fq.const(tw.FQ2_ONE_L, sig_x.device).expand(sig_x.shape)
    r_pk = C.pt_scalar_mul(C.F1, (pk_x, pk_y, one1), r_bits)
    r_sig = C.pt_scalar_mul(C.F2, (sig_x, sig_y, one2), r_bits)
    # padding lanes -> infinity so they vanish from the signature sum
    r_sig = C.pt_select(C.F2, mask, r_sig, C.pt_infinity(C.F2, r_sig))
    apx, apy, a_inf = g1_to_affine_dev(r_pk)
    return apx, apy, a_inf, r_sig


def rlc_scalar_mul(pk_x, pk_y, sig_x, sig_y, r_bits, mask, plain=False):
    """(apx, apy, a_inf, r_sig): r_i PK_i in affine with its infinity
    flag, r_i S_i Jacobian with the pad lanes at infinity.  K8 on a CUDA
    tensor, the plain version otherwise."""
    if _use_kernel(pk_x, plain):
        return K.rlc_scalar_mul_kernel(pk_x, pk_y, sig_x, sig_y, r_bits, mask)
    return rlc_scalar_mul_plain(pk_x, pk_y, sig_x, sig_y, r_bits, mask)


def rlc_miller_product_plain(apx, apy, a_inf, r_sig, h_x, h_y, h_ok, mask):
    B = apx.shape[0]
    sum_sig = C.pt_sum(C.F2, r_sig, B)
    sx, sy, s_inf = g2_to_affine_dev(tuple(c[None] for c in sum_sig))
    g1x, g1y = K.neg_g1_affine(apx.device)
    # pairing lanes: (r_i PK_i, H_i) for live i, plus (-G1, sum_sig)
    xp = torch.cat([apx, g1x[None]])
    yp = torch.cat([apy, g1y[None]])
    xq = torch.cat([h_x, sx])
    yq = torch.cat([h_y, sy])
    lane_mask = torch.cat([mask & ~a_inf & h_ok, ~s_inf])
    f = pj.miller_product_batch(xp, yp, xq, yq, lane_mask)
    return f, (sx, sy, s_inf)


def rlc_miller_product(apx, apy, a_inf, r_sig, h_x, h_y, h_ok, mask,
                       plain=False):
    """(f, (sx, sy, s_inf)): the affine sum of the signature lanes and the
    shared-accumulator Miller product over the B + 1 pairing lanes.  K9
    on a CUDA tensor, the plain version otherwise."""
    if _use_kernel(apx, plain):
        return K.rlc_miller_product_kernel(apx, apy, a_inf, r_sig, h_x, h_y,
                                           h_ok, mask)
    return rlc_miller_product_plain(apx, apy, a_inf, r_sig, h_x, h_y, h_ok,
                                    mask)


def final_exp_is_one_plain(f):
    fe = pj.final_exponentiate(f)
    return fe, tw.fq12_is_one(fe)[None]


def final_exp_is_one(f, plain=False):
    """(final_exponentiate(f), (1,) bool verdict).  K10 on a CUDA tensor,
    the plain version otherwise."""
    if _use_kernel(f, plain):
        return K.final_exp_is_one_kernel(f)
    return final_exp_is_one_plain(f)


def _rlc_pairing_core(pk_x, pk_y, sig_x, sig_y, h_x, h_y, h_ok, r_bits, mask,
                      plain=False, trace=None):
    """The three stages in order (JAX `_rlc_pairing_core`); returns the
    (1,) bool verdict.  With `trace` (a dict), every intermediate is
    stored in it."""
    apx, apy, a_inf, r_sig = rlc_scalar_mul(pk_x, pk_y, sig_x, sig_y,
                                            r_bits, mask, plain=plain)
    f, s_aff = rlc_miller_product(apx, apy, a_inf, r_sig, h_x, h_y, h_ok,
                                  mask, plain=plain)
    fe, ok = final_exp_is_one(f, plain=plain)
    if trace is not None:
        trace.update(apx=apx, apy=apy, a_inf=a_inf, r_sig=r_sig,
                     sum_sig=s_aff, miller=f, final_exp=fe, ok=ok)
    return ok


# --- host prep ----------------------------------------------------------------


def _prepare_rlc_inputs(tasks, rand):
    """Host-side prep (JAX `_prepare_rlc_inputs`, host hashing): drop
    trivial pairs, hash the messages, build limb arrays padded to the
    bucket ladder shape `_bucket(n_live)`.

    Returns (arrays, n_live): arrays (pk_x, pk_y, sig_x, sig_y, h_x, h_y,
    r_bits, mask) as numpy, or None when no batch is needed: then n_live
    is True (nothing to check) or, when some task has infinity on exactly
    one side (which the affine batch cannot carry), the list of live
    tasks, each to be checked on its own (`_task_check`)."""
    live = []
    for pk, msg, sig in tasks:
        if _pycurve.g1.is_inf(pk) and _pycurve.g2.is_inf(sig):
            continue          # 1 == 1 trivially; mirrors oracle skip
        live.append((pk, bytes(msg), sig))
    if not live:
        return None, True
    if any(_pycurve.g1.is_inf(pk) or _pycurve.g2.is_inf(sig)
           for pk, _, sig in live):
        return None, live

    B = _bucket(len(live))
    pk_x, pk_y = C.g1_affine_to_limbs([t[0] for t in live])
    h_x, h_y = C.g2_affine_to_limbs([hash_to_g2(t[1], DST_G2) for t in live])
    sig_x, sig_y = C.g2_affine_to_limbs([t[2] for t in live])
    scalars = [1] + [rand.getrandbits(RLC_SCALAR_BITS) | 1
                     for _ in range(len(live) - 1)]
    r_bits = C.scalars_to_bits(scalars, RLC_SCALAR_BITS)

    pad = B - len(live)
    if pad:
        def _p(a):
            return np.concatenate([a, np.repeat(a[:1], pad, 0)])
        pk_x, pk_y, h_x, h_y = _p(pk_x), _p(pk_y), _p(h_x), _p(h_y)
        sig_x, sig_y = _p(sig_x), _p(sig_y)
        r_bits = np.concatenate(
            [r_bits, np.zeros((pad, RLC_SCALAR_BITS), np.int32)])
    mask = np.arange(B) < len(live)
    return (pk_x, pk_y, sig_x, sig_y, h_x, h_y, r_bits, mask), len(live)


def _task_inputs(task):
    """One task as the inputs of the Miller stage at B = 1: lanes
    (PK, H(m)) and (-G1, S), an infinite side's lane masked (PK's affine
    form zero and its flag set; the signature enters as its own sum,
    r = 1, and an infinite sum masks its lane)."""
    pk, msg, sig = task
    a_inf = np.array([_pycurve.g1.is_inf(pk)])
    if a_inf[0]:
        apx = apy = np.zeros((1, _fq.N_LIMBS), np.int32)
    else:
        apx, apy = C.g1_affine_to_limbs([pk])
    h_x, h_y = C.g2_affine_to_limbs([hash_to_g2(msg, DST_G2)])
    if _pycurve.g2.is_inf(sig):
        one = tw.FQ2_ONE_L[None]
        r_sig = (one, one, np.zeros_like(one))
    else:
        sx, sy = C.g2_affine_to_limbs([sig])
        r_sig = (sx, sy, tw.FQ2_ONE_L[None])
    return (apx, apy, a_inf, r_sig, h_x, h_y, np.ones(1, bool),
            np.ones(1, bool))


def _to(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def _task_check(task, dev) -> bool:
    """e(PK, H(m)) · e(-G1, S) == 1 with an infinite side's pair dropped
    (the oracle's `pairing_check` skip; JAX runs `pairing_check_device`
    here), as a two-lane pairing check through the Miller stage and the
    final exponentiation."""
    apx, apy, a_inf, r_sig, h_x, h_y, h_ok, mask = _task_inputs(task)
    f, _ = rlc_miller_product(
        _to(apx, dev), _to(apy, dev), _to(a_inf, dev),
        tuple(_to(c, dev) for c in r_sig), _to(h_x, dev), _to(h_y, dev),
        _to(h_ok, dev), _to(mask, dev))
    return bool(final_exp_is_one(f)[1].item())


# --- the entry point ----------------------------------------------------------


def batch_verify(tasks, rng=None, device="cuda", device_h2c=False,
                 trace=None) -> bool:
    """tasks: [(g1_pubkey_jacobian, message_bytes, g2_sig_jacobian)]
    (oracle points of `consensus_specs_tpu_torch.ops.bls`).

    Verifies every FastAggregateVerify-style statement at once through
    K8 -> K9 -> K10 on `device` (CUDA by default; `device="cpu"` runs
    the plain versions).  `rng` draws the RLC coefficients
    (`random.Random`-like; default a system source) in JAX's order, so
    one seed gives both packages the same inputs.  With `trace` (a
    dict), the batch's inputs and every stage's outputs are stored in
    it."""
    if device_h2c:
        raise NotImplementedError(
            "batch_verify: device hash-to-curve (device_h2c=True) is not "
            "ported yet; it comes with slice 4 of the port")
    dev = resolve_device(device)
    if not tasks:
        return True
    rand = rng if rng is not None else secrets.SystemRandom()
    arrays, n = _prepare_rlc_inputs(tasks, rand)
    if arrays is None:
        return n is True or all(_task_check(t, dev) for t in n)
    pk_x, pk_y, sig_x, sig_y, h_x, h_y, r_bits, mask = (
        _to(a, dev) for a in arrays)
    h_ok = torch.ones_like(mask)
    if trace is not None:
        trace.update(inputs=(pk_x, pk_y, sig_x, sig_y, h_x, h_y, r_bits,
                             mask))
    return bool(_rlc_pairing_core(pk_x, pk_y, sig_x, sig_y, h_x, h_y, h_ok,
                                  r_bits, mask, trace=trace).item())
