"""The port's sharded epoch step (`parallel.make_sharded_epoch_step`: the
plain K24 phases with the collectives, the sharded balances and registry
roots) against the JAX package's `sharded_epoch_step` on the conftest's
8 virtual CPU devices, on virtual CPU meshes of the same width.
Tolerance zero: every output equal bit for bit.

- `__graft_entry__`'s seeded registry at 2**10 validators (the
  `dryrun_multichip` recipe: registry seed 1, leaf words seed 2) at
  D = 1, 2, 4 and 8, each shard's new balances and effective balances
  and every shard's replica of both roots (D copies, none aliasing
  another); also equal to the port's
  unsharded `make_epoch_step`;
- proposer indices that point into another shard, negative ones, and
  ones at or past the global length (JAX's drop rule over n_local * D);
- a `length` that ends inside a shard other than the last (the registry
  rows masked by their global index);
- the real-state path of `__graft_entry__.py:170`: a minimal phase0
  genesis state of 8 * D validators through each package's bridge
  (`registry_arrays_from_state`, `pad_pow2`,
  `validator_static_leaf_words`) and sharded step;
- the sharded step's argument checks and `partitioned_epoch_step`'s
  cache.

JAX's step is compiled once per mesh width (module cache)."""

import functools
import importlib

import jax
import numpy as np
import pytest
import torch

from consensus_specs_tpu.models.builder import build_spec
from consensus_specs_tpu.parallel import EpochParams
from consensus_specs_tpu.parallel import EpochScalars as JScalars
from consensus_specs_tpu.parallel import RegistryArrays as JRegistry
from consensus_specs_tpu.parallel import bridge as JBridge
from consensus_specs_tpu.parallel import partition as JP
from consensus_specs_tpu.testlib.helpers.genesis import create_genesis_state
from consensus_specs_tpu.utils import jaxtools
import consensus_specs_tpu_torch as T
from consensus_specs_tpu_torch import convert as C
from consensus_specs_tpu_torch import parallel as TP
from consensus_specs_tpu_torch.parallel import bridge as TBridge

N = 2**10
SC = (100, 2, 32_000_000_000)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def graft():
    """`__graft_entry__` without its process-wide compile-cache switch."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jaxtools, "enable_compile_cache", lambda *a, **k: None)
    try:
        return importlib.import_module("__graft_entry__")
    finally:
        mp.undo()


@functools.cache
def _jax_step(d: int, params):
    mesh = JP.build_mesh(n_devices=d, require_pow2=True)
    return mesh, JP.sharded_epoch_step(mesh, params)


def _jax_run(d, params, reg_np, sc, length, pk, cred):
    mesh, step = _jax_step(d, params)
    rules = JP.epoch_state_rules()
    reg_s = JP.shard_tree(mesh, JRegistry(*(np.asarray(a) for a in reg_np)),
                          rules)
    out = step(reg_s, JScalars(*(np.uint64(v) for v in sc)),
               np.uint64(length), jax.device_put(pk), jax.device_put(cred))
    return [np.asarray(o) for o in out]


def _torch_run(d, params, reg_np, sc, length, pk, cred):
    mesh = TP.make_mesh(devices=["cpu"] * d)
    regs, pks, creds = C.sharded_step_inputs(reg_np, pk, cred, mesh)
    return TP.make_sharded_epoch_step(mesh, params)(
        regs, TP.EpochScalars(*(int(v) for v in sc)), int(length), pks, creds)


def _same(got, want):
    new_bal, new_eff, bal_roots, reg_roots = got
    # the root is folded once and copied to each shard: D tensors, no
    # two sharing storage (a virtual mesh's kernels write in place)
    for roots in (bal_roots, reg_roots):
        assert len({r.untyped_storage().data_ptr() for r in roots}) == \
            len(new_bal)
    assert (C.u64_to_numpy(torch.cat(new_bal)) == want[0]).all()
    assert (C.u64_to_numpy(torch.cat(new_eff)) == want[1]).all()
    for r in bal_roots:
        assert (C.words_to_numpy(r) == want[2]).all()
    for r in reg_roots:
        assert (C.words_to_numpy(r) == want[3]).all()


@pytest.fixture(scope="module")
def mainnet():
    return EpochParams.from_spec(build_spec("phase0", "mainnet"))


@pytest.fixture(scope="module")
def flagship(graft):
    reg = graft._synthetic_registry(N, seed=1)
    pk, cred = C.synthetic_leaf_words(N, seed=2)
    return reg, pk, cred


@pytest.mark.parametrize("d", [1, 2, 4, 8])
def test_sharded_step_matches_jax(mainnet, flagship, d):
    reg, pk, cred = flagship
    want = _jax_run(d, mainnet, reg, SC, N, pk, cred)
    got = _torch_run(d, T.MAINNET, reg._asdict(), SC, N, pk, cred)
    _same(got, want)
    assert len(got[2]) == len(got[3]) == d
    single = T.make_epoch_step(T.MAINNET, device="cpu")(
        C.registry_to_torch(reg._asdict(), "cpu"),
        TP.EpochScalars(*SC), N, C.leaves_to_torch(pk, cred, "cpu"))
    assert torch.equal(torch.cat(got[0]), single[0])
    assert torch.equal(got[3][0], single[3])


@pytest.mark.parametrize("d", [2, 4])
def test_proposers_across_shards_negative_and_out_of_range(mainnet, flagship,
                                                           d):
    reg, pk, cred = flagship
    reg = reg._asdict()
    prop = reg["proposer_index"].copy()
    prop[::5] = (np.arange(0, N, 5) + N // 2) % N     # another shard
    prop[1::11] = -1                                  # the global last row
    prop[2::13] = -(N // d) - 3                       # counts from N, not N/d
    prop[3::17] = N                                   # dropped
    prop[4::19] = N + N // d                          # dropped
    prop[5::23] = -N - 1                              # dropped
    reg["proposer_index"] = prop
    want = _jax_run(d, mainnet, JRegistry(**reg), SC, N, pk, cred)
    _same(_torch_run(d, T.MAINNET, reg, SC, N, pk, cred), want)


@pytest.mark.parametrize("length", [N - 300, N // 4 + 1, 1])
def test_length_ending_inside_a_shard(mainnet, flagship, length):
    reg, pk, cred = flagship
    want = _jax_run(4, mainnet, reg, SC, length, pk, cred)
    got = _torch_run(4, T.MAINNET, reg._asdict(), SC, length, pk, cred)
    _same(got, want)


def test_real_state_through_both_bridges():
    spec = build_spec("phase0", "minimal")
    d = 2
    n_real = 8 * d
    state = create_genesis_state(
        spec, [int(spec.MAX_EFFECTIVE_BALANCE)] * n_real,
        int(spec.MAX_EFFECTIVE_BALANCE))
    spec.process_slots(state, spec.Slot(int(spec.SLOTS_PER_EPOCH) + 1))
    jreg, jsc = JBridge.registry_arrays_from_state(spec, state)
    treg, tsc = TBridge.registry_arrays_from_state(spec, state)
    for f in JRegistry._fields:
        a, b = np.asarray(getattr(jreg, f)), getattr(treg, f)
        got = (C.u64_to_numpy(b) if b.dtype == torch.int64 else b.numpy())
        assert (got == a).all() and got.dtype == a.dtype, f
    assert tsc == tuple(int(v) for v in jsc)
    jpk, jcred = JBridge.validator_static_leaf_words(spec, state)
    tpk, tcred = TBridge.validator_static_leaf_words(spec, state)
    assert (C.words_to_numpy(tpk) == jpk).all()
    assert (C.words_to_numpy(tcred) == jcred).all()

    jreg = JRegistry(*(JBridge.pad_pow2(np.asarray(a), multiple_of=d)
                       for a in jreg))
    jpk, jcred = (JBridge.pad_pow2(a, multiple_of=d) for a in (jpk, jcred))
    treg = TP.RegistryArrays(*(TBridge.pad_pow2(a, multiple_of=d)
                               for a in treg))
    tpk, tcred = (TBridge.pad_pow2(a, multiple_of=d) for a in (tpk, tcred))
    jparams = EpochParams.from_spec(spec)
    want = _jax_run(d, jparams, jreg, tuple(int(v) for v in jsc), n_real,
                    jpk, jcred)
    mesh = TP.make_mesh(devices=["cpu"] * d)
    leaves = TP.shard_tree(mesh, {"pubkey_root": tpk, "credentials": tcred})
    got = TP.make_sharded_epoch_step(mesh, T.MINIMAL)(
        TP.shard_registry(mesh, treg), tsc, n_real,
        [s["pubkey_root"] for s in leaves],
        [s["credentials"] for s in leaves])
    _same(got, want)


def test_pad_pow2_matches_jax():
    for n, m in ((5, 1), (5, 4), (8, 8), (1, 2), (17, 4)):
        a = np.arange(n * 2, dtype=np.uint64).reshape(n, 2)
        want = JBridge.pad_pow2(a, multiple_of=m)
        assert (TBridge.pad_pow2(a, multiple_of=m) == want).all()
        got = TBridge.pad_pow2(torch.from_numpy(a.view(np.int64)),
                               multiple_of=m)
        assert (got.numpy().view(np.uint64) == want).all()
    with pytest.raises(ValueError):
        TBridge.pad_pow2(np.zeros(3), multiple_of=3)


def test_sharded_step_checks_its_shards():
    n, d = 64, 4
    reg = C.synthetic_registry(n)
    pk, cred = C.synthetic_leaf_words(n)
    mesh = TP.make_mesh(devices=["cpu"] * d)
    regs, pks, creds = C.sharded_step_inputs(reg, pk, cred, mesh)
    step = TP.make_sharded_epoch_step(mesh, T.MAINNET)
    with pytest.raises(ValueError, match="4 shards"):
        step(regs[:2], TP.EpochScalars(*SC), n, pks, creds)
    with pytest.raises(ValueError, match="chunk-aligned"):
        TP.balances_list_root_sharded(
            [torch.zeros(6, dtype=torch.int64)] * 2, 12)
    with pytest.raises(ValueError, match="power of two"):
        TP.make_mesh(devices=["cpu"] * 3)


def test_partitioned_epoch_step_caches_per_topology():
    a = TP.partitioned_epoch_step(T.MAINNET, devices=["cpu"] * 2)
    b = TP.partitioned_epoch_step(T.MAINNET, devices=("cpu", "cpu"))
    c = TP.partitioned_epoch_step(T.MAINNET, devices=["cpu"] * 4)
    assert a is b and a is not c
