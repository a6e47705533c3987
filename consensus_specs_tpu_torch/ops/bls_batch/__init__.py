"""Batched BLS on the card (counterpart of `consensus_specs_tpu.ops.bls_batch`):
the random-linear-combination (RLC) batch verify of FastAggregateVerify
statements, the precomputed-line pairing check and the G1 multiscalar
multiplication.

`batch_verify(tasks, rng, device="cuda")` checks B statements
e(PK_i, H(m_i)) == e(G1, S_i) at once: with r_0 = 1 and the other r_i
random odd 128-bit values, it accepts iff
    prod_i e(r_i PK_i, H_i) · e(-G1, sum_i r_i S_i) == 1,
B + 1 pairings through one shared Fq12 Miller accumulator and ONE final
exponentiation (JAX's docstring gives the 2^-127 soundness argument).
The host parses and packs (`_prepare_rlc_inputs`); with 32-byte messages
it leaves the hashing to the device too, as JAX does by default.

`pairing_check_device(pairs)` is the oracle's `pairing_check` on the
device: the G2 arguments are host points, so their Miller lines are
precomputed on the host once per point and the device evaluates them.
`g1_multi_exp_device(points, scalars)` is a G1 MSM: Pippenger up to 512
lanes, double-and-add above.

Each device stage is a kernel on a CUDA tensor and its plain PyTorch
version on a CPU tensor (or with `plain=True`):

    hash_to_g2_affine       K11  messages -> H(m) affine with its flag
    rlc_scalar_mul          K8   r_i PK_i to affine, r_i S_i (pad lanes inf)
    rlc_miller_product      K9   the G2 sum to affine, the Miller product
    precomp_miller_product  K12  the Miller product over host lines
    final_exp_is_one        K10  the final exponentiation and the verdict
    msm_pippenger           K13  the bucketed G1 MSM
    msm_double_add          K14  the double-and-add G1 MSM

The plain stages compose exactly as JAX's programs (`_rlc_kernel_h2c`,
`_rlc_kernel`, `_pairing_check_precomp_fn`, `_msm_pippenger_kernel`,
`_msm_kernel`), so on the CPU every intermediate equals JAX's limb for
limb; the kernels return canonical limbs, equal to `fq_canon` of the
plain ones.  No stage falls back to another route when a kernel fails
to build or launch.

The sharded batch and MSM run over a mesh (`parallel.partition
.build_mesh`: the first `n_devices` cards, the `device_ids` cards, or an
explicit `devices` list, which may repeat a device).
`batch_verify_sharded` splits the padded lanes into D contiguous shards
and runs K8 and K25 on each shard's device; the D partial signature sums
and Miller products are gathered to the mesh's first device, where K26
folds them with the shared (-G1, sum) lane and K10 decides.
`g1_multi_exp_sharded` runs K13 per shard and K27 over the gathered
partials.  JAX replicates that tail on every device (`out_specs=P()`);
the port runs it once, on the first.  An implicit request for one device
degrades to the single-card entry point, as in JAX; an explicit
`device_ids` or `devices` list never does:

    rlc_miller_shard        K25  K9 on a shard's lanes, no shared lane
    rlc_shard_combine       K26  the G2 fold, the shared lane, the product
    g1_shard_fold           K27  the G1 fold of the MSM partials

The `*_async` entry points are not ported yet.  Nothing here is timed,
faulted or telemetered.
"""

from __future__ import annotations

import secrets

import numpy as np
import torch

from ... import resolve_device
from ...parallel.collectives import gather, on
from ..bls import curve as _pycurve
from ..bls.hash_to_curve import DST_G2, hash_to_g2
from . import curve as C
from . import fq as _fq
from . import h2c
from . import kernels as K
from . import pairing as pj
from . import tower as tw

RLC_SCALAR_BITS = 128     # soundness 2^-127 per forged batch (odd draws)
SCALAR_BITS = 255         # BLS12-381 subgroup order is 255 bits

# batch-shape ladder (JAX `ops/bls_batch/__init__.py:91`)
_BUCKET_STEPS = (8, 32, 128, 512)

# Pippenger up to this many lanes, double-and-add above (JAX `:405`)
_MSM_PIPPENGER_MAX = 512


def _bucket(n: int) -> int:
    """Padded batch shape for n live lanes: the next power of two,
    quantized UP to the 4-step ladder; n <= 1 maps to the bottom rung."""
    b = 1 if n <= 1 else 1 << (n - 1).bit_length()
    for step in _BUCKET_STEPS:
        if b <= step:
            return step
    return b


def _to(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def _pad_rows(a: np.ndarray, pad: int, axis: int = 0) -> np.ndarray:
    """Pad `a` along `axis` by repeating its first row `pad` times."""
    first = np.take(a, [0], axis=axis)
    return np.concatenate([a, np.repeat(first, pad, axis)], axis=axis)


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


# --- the stages ---------------------------------------------------------------


def hash_to_g2_affine_plain(msg_words):
    h_x, h_y, h_inf = g2_to_affine_dev(h2c.hash_to_g2_dev(msg_words))
    return h_x, h_y, ~h_inf


def hash_to_g2_affine(msg_words, plain=False):
    """(h_x, h_y, h_ok): the B messages' hashes to G2 in affine form and
    ~infinity, from (B, 8) int32 message words (JAX `_rlc_kernel_h2c`'s
    `hash_to_g2_dev` then `g2_to_affine_dev`).  K11 on a CUDA tensor, the
    plain version otherwise."""
    if _use_kernel(msg_words, plain):
        return K.hash_to_g2_kernel(msg_words)
    return hash_to_g2_affine_plain(msg_words)


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


def precomp_miller_product(xp, yp, lines, mask, plain=False):
    """The shared-accumulator Miller product over host-precomputed lines
    (JAX `pairing_jax.miller_product_precomp`): one Fq12.  K12 on a CUDA
    tensor, the plain version otherwise."""
    if _use_kernel(xp, plain):
        return K.precomp_miller_product_kernel(xp, yp, lines, mask)
    return pj.miller_product_precomp(xp, yp, lines, mask)


def final_exp_is_one_plain(f):
    fe = pj.final_exponentiate(f)
    return fe, tw.fq12_is_one(fe)[None]


def final_exp_is_one(f, plain=False):
    """(final_exponentiate(f), (1,) bool verdict).  K10 on a CUDA tensor,
    the plain version otherwise."""
    if _use_kernel(f, plain):
        return K.final_exp_is_one_kernel(f)
    return final_exp_is_one_plain(f)


def rlc_miller_shard_plain(apx, apy, a_inf, r_sig, h_x, h_y, h_ok, mask):
    B = apx.shape[0]
    total = C.pt_sum(C.F2, r_sig, B)
    f = pj.miller_product_batch(apx, apy, h_x, h_y, mask & ~a_inf & h_ok)
    return f, total


def rlc_miller_shard(apx, apy, a_inf, r_sig, h_x, h_y, h_ok, mask,
                     plain=False):
    """(f, (sX, sY, sZ)): one shard's Miller product over its B lanes
    (no shared lane) and the Jacobian sum of its signature lanes (JAX
    `_rlc_kernel_sharded`'s local body).  K25 on a CUDA tensor, the plain
    version otherwise."""
    if _use_kernel(apx, plain):
        return K.rlc_miller_shard_kernel(apx, apy, a_inf, r_sig, h_x, h_y,
                                         h_ok, mask)
    return rlc_miller_shard_plain(apx, apy, a_inf, r_sig, h_x, h_y, h_ok,
                                  mask)


def rlc_shard_combine_plain(sums, fs):
    D = fs.shape[0]
    sum_sig = C.pt_sum(C.F2, sums, D)
    total = pj._product_tree(fs, D)
    sx, sy, s_inf = g2_to_affine_dev(tuple(c[None] for c in sum_sig))
    g1x, g1y = K.neg_g1_affine(fs.device)
    f_extra = pj.miller_product_batch(g1x[None], g1y[None], sx, sy, ~s_inf)
    return tw.fq12_mul(total, f_extra), (sx, sy, s_inf)


def rlc_shard_combine(sums, fs, plain=False):
    """(f, (sx, sy, s_inf)) from the D shards' gathered partials: the G2
    sum in affine form, the Miller loop of (-G1, sum), times the product
    of the D Fq12 partials (JAX `_rlc_kernel_sharded` after its two
    all_gathers).  K26 on a CUDA tensor, the plain version otherwise."""
    if _use_kernel(fs, plain):
        return K.rlc_shard_combine_kernel(sums, fs)
    return rlc_shard_combine_plain(sums, fs)


def _rlc_pairing_core(pk_x, pk_y, sig_x, sig_y, h_x, h_y, h_ok, r_bits, mask,
                      plain=False, trace=None):
    """K8 -> K9 -> K10 in order (JAX `_rlc_pairing_core`); returns the
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


# --- pairing check --------------------------------------------------------------


def pairing_check_inputs(pairs):
    """The host side of `pairing_check_device` (JAX `:230-274`): drop the
    pairs with a side at infinity (the oracle's skip), pad the live ones
    to `_bucket(n)` by repeating lane 0, precompute the G2 lines.
    Returns numpy (xp, yp, lines, mask), or None when no pair is live."""
    live = [(p, q) for p, q in pairs
            if not _pycurve.g1.is_inf(p) and not _pycurve.g2.is_inf(q)]
    if not live:
        return None
    B = _bucket(len(live))
    xp, yp = C.g1_affine_to_limbs([p for p, _ in live])
    # (n_bits, B_live, 6, 2, 33): per-bit line coefficients per pair
    lines = np.stack([pj.precompute_g2_lines(q) for _, q in live], axis=1)
    pad = B - len(live)
    if pad:
        xp, yp = _pad_rows(xp, pad), _pad_rows(yp, pad)
        lines = _pad_rows(lines, pad, axis=1)
    return xp, yp, lines, np.arange(B) < len(live)


def pairing_check_device(pairs, device="cuda") -> bool:
    """pairs: [(g1_jacobian, g2_jacobian)] oracle points.  The product of
    the pairings == 1, through K12 -> K10 on a CUDA `device`, and on any
    other through the plain `pairing.multi_pairing_check_precomp`; pairs
    with a side at infinity contribute the identity."""
    dev = resolve_device(device)
    arrays = pairing_check_inputs(pairs)
    if arrays is None:
        return True
    xp, yp, lines, mask = (_to(a, dev) for a in arrays)
    if not _use_kernel(xp, False):
        return bool(pj.multi_pairing_check_precomp(xp, yp, lines,
                                                   mask).item())
    f = precomp_miller_product(xp, yp, lines, mask)
    return bool(final_exp_is_one(f)[1].item())


# --- host prep ----------------------------------------------------------------


def _prepare_rlc_inputs(tasks, rand, device_h2c=False, device="cuda",
                        lanes=None):
    """Host-side prep (JAX `_prepare_rlc_inputs`): drop trivial pairs,
    hash the messages (host) or pack them as words (device hashing),
    build limb arrays padded to `lanes` rows, or to the bucket ladder
    shape `_bucket(n_live)` when `lanes` is None.

    Returns (arrays, n_live): arrays (pk_x, pk_y, sig_x, sig_y, h_x, h_y,
    r_bits, mask) as numpy, with (h_x, h_y) replaced by one (B, 8) int32
    message-word matrix under `device_h2c`.  Or (None, verdict) where no
    batch is needed: nothing to check, or some task with infinity on
    exactly one side (which the affine batch cannot carry): then each
    task is checked on its own by `pairing_check_device` on `device`."""
    live = []
    for pk, msg, sig in tasks:
        if _pycurve.g1.is_inf(pk) and _pycurve.g2.is_inf(sig):
            continue          # 1 == 1 trivially; mirrors oracle skip
        live.append((pk, bytes(msg), sig))
    if not live:
        return None, True
    if any(_pycurve.g1.is_inf(pk) or _pycurve.g2.is_inf(sig)
           for pk, _, sig in live):
        neg_g1 = _pycurve.g1.neg(_pycurve.G1_GEN)
        return None, all(
            pairing_check_device([(pk, hash_to_g2(msg, DST_G2)),
                                  (neg_g1, sig)], device=device)
            for pk, msg, sig in live)

    B = _bucket(len(live)) if lanes is None else lanes
    if B < len(live):
        raise ValueError(f"{len(live)} live statements in {B} lanes")
    pk_x, pk_y = C.g1_affine_to_limbs([t[0] for t in live])
    if device_h2c:
        h_arrays = (h2c.msgs_to_words([t[1] for t in live]).view(np.int32),)
    else:
        h_arrays = C.g2_affine_to_limbs(
            [hash_to_g2(t[1], DST_G2) for t in live])
    sig_x, sig_y = C.g2_affine_to_limbs([t[2] for t in live])
    scalars = [1] + [rand.getrandbits(RLC_SCALAR_BITS) | 1
                     for _ in range(len(live) - 1)]
    r_bits = C.scalars_to_bits(scalars, RLC_SCALAR_BITS)

    pad = B - len(live)
    if pad:
        pk_x, pk_y = _pad_rows(pk_x, pad), _pad_rows(pk_y, pad)
        h_arrays = tuple(_pad_rows(a, pad) for a in h_arrays)
        sig_x, sig_y = _pad_rows(sig_x, pad), _pad_rows(sig_y, pad)
        r_bits = np.concatenate(
            [r_bits, np.zeros((pad, RLC_SCALAR_BITS), np.int32)])
    mask = np.arange(B) < len(live)
    return ((pk_x, pk_y, sig_x, sig_y) + h_arrays + (r_bits, mask),
            len(live))


# --- the RLC batch ----------------------------------------------------------------


def batch_verify(tasks, rng=None, device="cuda", device_h2c=True,
                 trace=None) -> bool:
    """tasks: [(g1_pubkey_jacobian, message_bytes, g2_sig_jacobian)]
    (oracle points of `consensus_specs_tpu_torch.ops.bls`).

    Verifies every FastAggregateVerify-style statement at once on
    `device` (CUDA by default; `device="cpu"` runs the plain versions):
    K11 -> K8 -> K9 -> K10 with the messages hashed on the device, or
    K8 -> K9 -> K10 with host hashing.  `device_h2c` (default True)
    hashes on the device when every message is 32 bytes, the length
    K11 is specialized to, and on the host otherwise, as JAX routes
    them; `device_h2c=False` always hashes on the host.
    `rng` draws the RLC coefficients (`random.Random`-like; default a
    system source) in JAX's order, so one seed gives both packages the
    same inputs.  With `trace` (a dict), the batch's inputs and every
    stage's outputs are stored in it."""
    dev = resolve_device(device)
    if not tasks:
        return True
    rand = rng if rng is not None else secrets.SystemRandom()
    device_h2c = device_h2c and all(
        len(bytes(m)) == h2c.MSG_BYTES for _, m, _ in tasks)
    arrays, n = _prepare_rlc_inputs(tasks, rand, device_h2c, dev)
    if arrays is None:
        return bool(n)
    inputs = tuple(_to(a, dev) for a in arrays)
    if device_h2c:
        pk_x, pk_y, sig_x, sig_y, words, r_bits, mask = inputs
        h_x, h_y, h_ok = hash_to_g2_affine(words)
    else:
        pk_x, pk_y, sig_x, sig_y, h_x, h_y, r_bits, mask = inputs
        h_ok = torch.ones_like(mask)
    if trace is not None:
        trace.update(inputs=inputs, h_x=h_x, h_y=h_y, h_ok=h_ok)
    return bool(_rlc_pairing_core(pk_x, pk_y, sig_x, sig_y, h_x, h_y, h_ok,
                                  r_bits, mask, trace=trace).item())


def _mesh_for(n_devices, device_ids, devices):
    """The mesh of a sharded call, or None where JAX degrades to the
    single-card path: an implicit request (no `device_ids`, no `devices`)
    for at most one of the available cards."""
    from ...parallel.partition import available_devices, build_mesh

    if devices is not None:
        return build_mesh(devices=devices)
    if device_ids is not None:
        return build_mesh(device_ids=device_ids)
    available = available_devices()
    n = available if n_devices is None else min(int(n_devices), available)
    if n <= 1:
        return None
    return build_mesh(n_devices=n)


def _shards(arrays, mesh, per_shard: int) -> list:
    """The padded numpy arrays split into the mesh's contiguous shards of
    `per_shard` rows, each shard's on its device."""
    return [tuple(_to(a[d * per_shard:(d + 1) * per_shard], dev)
                  for a in arrays) for d, dev in enumerate(mesh.devices)]


def batch_verify_sharded(tasks, n_devices=None, rng=None, device_ids=None,
                         devices=None, trace=None) -> bool:
    """`batch_verify` with the lanes sharded over a mesh (JAX
    `batch_verify_sharded`, `:782`), the messages hashed on the host: the
    n tasks padded to D x `_bucket(ceil(n / D))` lanes, shard d's
    contiguous lanes through K8 and K25 on its device, the D partial
    signature sums and Miller products gathered to the first device,
    then K26 and K10 there; the plain versions on the CPU.  `rng` draws
    the same scalars in the same order as `batch_verify` and JAX.  The
    verdict is `batch_verify`'s.  An implicit one-card request runs
    `batch_verify`.  With `trace` (a dict), the shards' partials, the
    combined f, its final exponentiation and the verdict are stored in
    it."""
    if not tasks:
        return True
    mesh = _mesh_for(n_devices, device_ids, devices)
    if mesh is None:
        return batch_verify(tasks, rng=rng)
    rand = rng if rng is not None else secrets.SystemRandom()
    per_shard = _bucket(-(-len(tasks) // mesh.size))
    first = mesh.devices[0]
    arrays, n = _prepare_rlc_inputs(tasks, rand, False, first,
                                    lanes=mesh.size * per_shard)
    if arrays is None:
        return bool(n)
    fs, sums = [], []
    for dev, t in zip(mesh.devices, _shards(arrays, mesh, per_shard)):
        pk_x, pk_y, sig_x, sig_y, h_x, h_y, r_bits, mask = t
        with on(dev):
            apx, apy, a_inf, r_sig = rlc_scalar_mul(
                pk_x, pk_y, sig_x, sig_y, r_bits, mask)
            f, total = rlc_miller_shard(apx, apy, a_inf, r_sig, h_x, h_y,
                                        torch.ones_like(mask), mask)
        fs.append(f)
        sums.append(total)
    g_sums = tuple(gather([s[k] for s in sums], first) for k in range(3))
    g_fs = gather(fs, first)
    with on(first):
        f, s_aff = rlc_shard_combine(g_sums, g_fs)
        fe, ok = final_exp_is_one(f)
    if trace is not None:
        trace.update(partial_sums=g_sums, partial_f=g_fs, miller=f,
                     sum_sig=s_aff, final_exp=fe, ok=ok)
    return bool(ok.item())


# --- G1 multiscalar multiplication ----------------------------------------------


def _msm_window(n: int) -> int:
    """Pippenger window size for an n-point batch (JAX `:388`)."""
    if n < 32:
        return 4
    if n < 256:
        return 6
    if n < 2048:
        return 8
    return 10


def _msm_algo(batch: int, algo=None) -> str:
    """"pippenger" up to `_MSM_PIPPENGER_MAX` lanes, "double-add" above,
    unless `algo` names one (JAX `:408`, there from an environment
    variable)."""
    if algo is None:
        return "pippenger" if batch <= _MSM_PIPPENGER_MAX else "double-add"
    assert algo in ("pippenger", "double-add"), algo
    return algo


def msm_pippenger_plain(x, y, digits, c: int):
    one1 = _fq.const(_fq.ONE_MONT, x.device).expand(x.shape)
    return C.pt_msm_pippenger(C.F1, (x, y, one1), digits, c)


def msm_pippenger(x, y, digits, c: int, plain=False):
    """sum_i k_i P_i as one Jacobian G1 point (X, Y, Z), each (33,), by
    Pippenger's buckets (JAX `_msm_pippenger_kernel`); digits (B, W)
    c-bit windows, most significant first.  K13 on a CUDA tensor, the
    plain version otherwise."""
    if _use_kernel(x, plain):
        return K.msm_pippenger_kernel(x, y, digits, c)
    return msm_pippenger_plain(x, y, digits, c)


def msm_double_add_plain(x, y, bits, mask):
    B = x.shape[0]
    one1 = _fq.const(_fq.ONE_MONT, x.device).expand(x.shape)
    muls = C.pt_scalar_mul(C.F1, (x, y, one1), bits)
    muls = C.pt_select(C.F1, mask, muls, C.pt_infinity(C.F1, muls))
    return C.pt_sum(C.F1, muls, B)


def msm_double_add(x, y, bits, mask, plain=False):
    """sum_i k_i P_i as one Jacobian G1 point by a 255-bit double-and-add
    on every lane and a tree sum (JAX `_msm_kernel`); bits (B, 255)
    MSB first, mask (B,).  K14 on a CUDA tensor, the plain version
    otherwise."""
    if _use_kernel(x, plain):
        return K.msm_double_add_kernel(x, y, bits, mask)
    return msm_double_add_plain(x, y, bits, mask)


def msm_inputs(points, scalars, algo=None):
    """The host side of `g1_multi_exp_device` (JAX `:757-816`): drop the
    zero scalars and the points at infinity, pad to `_bucket(n)` by
    repeating lane 0 with zero scalars.  Returns (algo, c, arrays):
    numpy (x, y, digits) for "pippenger" (c its window), (x, y, bits,
    mask) for "double-add" (c None); or None when no lane is live."""
    assert len(points) == len(scalars) and len(points) > 0
    live = []
    for p, s in zip(points, scalars):
        s = int(s) % _pycurve.R
        if s == 0 or _pycurve.g1.is_inf(p):
            continue
        live.append((p, s))
    if not live:
        return None
    B = _bucket(len(live))
    algo = _msm_algo(B, algo)
    x, y = C.g1_affine_to_limbs([p for p, _ in live])
    pad = B - len(live)
    ks = [s for _, s in live]
    if algo == "pippenger":
        c = _msm_window(B)
        k = C.scalars_to_digits(ks, SCALAR_BITS, c)
        extra = ()
    else:
        c = None
        k = C.scalars_to_bits(ks, SCALAR_BITS)
        extra = (np.arange(B) < len(live),)
    if pad:
        x, y = _pad_rows(x, pad), _pad_rows(y, pad)
        k = np.concatenate([k, np.zeros((pad,) + k.shape[1:], np.int32)])
    return algo, c, (x, y, k) + extra


def g1_multi_exp_device(points, scalars, device="cuda", algo=None):
    """G1 multiscalar multiplication on `device`: points oracle Jacobian
    G1 points, scalars ints (reduced mod r).  Pippenger (K13) up to
    `_MSM_PIPPENGER_MAX` lanes, double-and-add (K14) above, or the one
    `algo` names; the plain versions on the CPU.  Returns an oracle
    Jacobian point."""
    dev = resolve_device(device)
    prepared = msm_inputs(points, scalars, algo)
    if prepared is None:
        return _pycurve.g1.infinity()
    algo, c, arrays = prepared
    t = tuple(_to(a, dev) for a in arrays)
    out = msm_pippenger(*t, c) if algo == "pippenger" else msm_double_add(*t)
    return C.g1_limbs_to_oracle(out)


def g1_shard_fold_plain(x, y, z):
    return C.pt_sum(C.F1, (x, y, z), x.shape[0])


def g1_shard_fold(x, y, z, plain=False):
    """The sum of D Jacobian G1 points (x, y, z, each (D, 33)) in
    `pt_sum`'s tree (JAX `_msm_sharded_kernel`'s fold).  K27 on a CUDA
    tensor, the plain version otherwise."""
    if _use_kernel(x, plain):
        return K.g1_shard_fold_kernel(x, y, z)
    return g1_shard_fold_plain(x, y, z)


def g1_multi_exp_sharded(points, scalars, n_devices=None, device_ids=None,
                         devices=None, device="cuda"):
    """`g1_multi_exp_device` over a mesh (JAX `g1_multi_exp_sharded`,
    `:522`): the live lanes padded to D x `_bucket(ceil(live / D))` (pad
    lanes repeat point 0 with zero digits), Pippenger with the window of
    the per-shard count on each shard (K13), the D partials gathered to
    the first device and summed there (K27); the plain versions on the
    CPU.  An implicit one-card request runs `g1_multi_exp_device` on
    `device`.  Returns an oracle Jacobian point."""
    assert len(points) == len(scalars) and len(points) > 0
    mesh = _mesh_for(n_devices, device_ids, devices)
    if mesh is None:
        return g1_multi_exp_device(points, scalars, device=device)
    live = []
    for p, k in zip(points, scalars):
        k = int(k) % _pycurve.R
        if k == 0 or _pycurve.g1.is_inf(p):
            continue
        live.append((p, k))
    if not live:
        return _pycurve.g1.infinity()
    per_shard = _bucket(-(-len(live) // mesh.size))
    c = _msm_window(per_shard)
    x, y = C.g1_affine_to_limbs([p for p, _ in live])
    digits = C.scalars_to_digits([k for _, k in live], SCALAR_BITS, c)
    pad = mesh.size * per_shard - len(live)
    if pad:
        x, y = _pad_rows(x, pad), _pad_rows(y, pad)
        digits = np.concatenate(
            [digits, np.zeros((pad,) + digits.shape[1:], np.int32)])
    partials = []
    for dev, t in zip(mesh.devices, _shards((x, y, digits), mesh, per_shard)):
        with on(dev):
            partials.append(msm_pippenger(*t, c))
    first = mesh.devices[0]
    gathered = [gather([p[k] for p in partials], first) for k in range(3)]
    with on(first):
        out = g1_shard_fold(*gathered)
    return C.g1_limbs_to_oracle(out)
