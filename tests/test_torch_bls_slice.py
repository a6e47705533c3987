"""Slice 3 of the port, stage by stage: the port's plain `batch_verify`
at bucket 8 (2 live statements, host hashing) keeps every intermediate
and each equals the JAX package's component on the same arrays, limb
for limb: r·PK in affine form with its infinity flags, the signature
lanes r·S (pad lanes at infinity), the affine G2 sum, the shared Miller
product and the final exponentiation.  The JAX side composes
`consensus_specs_tpu.ops.bls_batch`'s own functions as its
`_rlc_pairing_core` does, in three jitted stages (the verdict against
JAX's `batch_verify` itself is in `tests/test_torch_bls_verify.py`)."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consensus_specs_tpu.ops import bls_batch as JB
from consensus_specs_tpu.ops.bls import ciphersuite as Jcs
from consensus_specs_tpu.ops.bls import curve as Jcurve
from consensus_specs_tpu.ops.bls_batch import curve_jax as Jc
from consensus_specs_tpu.ops.bls_batch import fq as Jf
from consensus_specs_tpu.ops.bls_batch import pairing_jax as Jp
from consensus_specs_tpu.ops.bls_batch import tower as Jt
from consensus_specs_tpu_torch.ops import bls_batch as TB
from consensus_specs_tpu_torch.ops.bls import ciphersuite as Tcs

SEED = 5


def _port_tasks(n):
    """n one-key statements parsed by the port from the JAX package's
    wire bytes."""
    out = []
    for t in range(n):
        msg = (1000 + t).to_bytes(32, "little")
        out.append(Tcs.parse_fast_aggregate_task(
            [Jcs.SkToPk(1000 + t)], msg, Jcs.Sign(1000 + t, msg)))
    return out


def _same(got, want):
    if isinstance(got, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
        return
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)


def _jax_stage1(pk_x, pk_y, sig_x, sig_y, r_bits, mask):
    one1 = jnp.broadcast_to(jnp.asarray(Jf.ONE_MONT),
                            pk_x.shape).astype(jnp.int32)
    one2 = jnp.broadcast_to(jnp.asarray(Jt.FQ2_ONE_L),
                            sig_x.shape).astype(jnp.int32)
    r_pk = Jc.pt_scalar_mul(Jc.F1, (pk_x, pk_y, one1), r_bits)
    r_sig = Jc.pt_scalar_mul(Jc.F2, (sig_x, sig_y, one2), r_bits)
    r_sig = Jc.pt_select(Jc.F2, mask, r_sig, Jc.pt_infinity(Jc.F2, r_sig))
    return JB.g1_to_affine_dev(r_pk), r_sig


def _jax_stage2(apx, apy, a_inf, r_sig, h_x, h_y, mask):
    neg_g1 = Jc.g1_affine_to_limbs([Jcurve.g1.neg(Jcurve.G1_GEN)])
    sum_sig = Jc.pt_sum(Jc.F2, r_sig, apx.shape[0])
    sx, sy, s_inf = JB.g2_to_affine_dev(tuple(c[None] for c in sum_sig))
    xp = jnp.concatenate([apx, jnp.asarray(neg_g1[0])])
    yp = jnp.concatenate([apy, jnp.asarray(neg_g1[1])])
    xq = jnp.concatenate([h_x, sx])
    yq = jnp.concatenate([h_y, sy])
    lane_mask = jnp.concatenate([mask & ~a_inf, ~s_inf])
    return Jp.miller_product_batch(xp, yp, xq, yq, lane_mask), (sx, sy, s_inf)


def _jax_stage3(f):
    fe = Jp.final_exponentiate(f)
    return fe, Jt.fq12_is_one(fe)


@pytest.fixture(scope="module")
def slice8():
    """Two live statements at bucket 8: the port's plain batch with its
    intermediates, and the JAX package's components on the same arrays."""
    trace = {}
    ok = TB.batch_verify(_port_tasks(2), rng=random.Random(SEED),
                         device="cpu", device_h2c=False, trace=trace)
    np_args = [a.numpy() for a in trace["inputs"]]
    (apx, apy, a_inf), r_sig = jax.jit(_jax_stage1)(
        *np_args[:4], np_args[6], np_args[7])
    f, s_aff = jax.jit(_jax_stage2)(apx, apy, a_inf, r_sig, np_args[4],
                                    np_args[5], np_args[7])
    fe, jok = jax.jit(_jax_stage3)(f)
    jax_parts = jax.tree_util.tree_map(np.asarray, dict(
        apx=apx, apy=apy, a_inf=a_inf, r_sig=r_sig, sum_sig=s_aff,
        miller=f, final_exp=fe, ok=jok))
    return dict(ok=ok, trace=trace, jax=jax_parts)


@pytest.mark.parametrize("part", ["apx", "apy", "a_inf", "r_sig", "sum_sig",
                                  "miller", "final_exp"])
def test_whole_slice_intermediates_equal_jax(slice8, part):
    _same(slice8["trace"][part], slice8["jax"][part])
    assert slice8["ok"] is True and bool(slice8["jax"]["ok"]) is True


def test_whole_slice_pad_lanes_and_pinned_coefficient(slice8):
    tr = slice8["trace"]
    assert tr["a_inf"].tolist() == [False, False] + [True] * 6
    z = TB._fq.fq_canon(tr["r_sig"][2]).reshape(8, -1)
    assert not z[2:].any() and z[:2].any(axis=1).all()
    assert tr["sum_sig"][2].tolist() == [False]
    r_bits = tr["inputs"][6]
    assert r_bits[0, -1] == 1 and not r_bits[0, :-1].any()    # r_0 = 1
