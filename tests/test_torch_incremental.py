"""The port's incremental Merkle forests (plain versions of kernels K4, K5,
K6 and of K3's gather mode) against the JAX
`parallel.incremental`, bit for bit, on the same seeded numpy inputs:
the dirty-count ladder, builds, dirty-path updates in both regimes,
balance-chunk packing, proof paths and proofs, forests carried across
with `from_layers`, and bench's composed incremental epoch step at 2**12
validators.  Tolerance: zero (exact integer arithmetic).

JAX compiles each forest depth and dirty rung once per process; the
cases keep depths small and reuse a few shapes."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consensus_specs_tpu.models.builder import build_spec
from consensus_specs_tpu.parallel import (EpochParams, EpochScalars,
                                          ValidatorLeaves, epoch_sweep)
from consensus_specs_tpu.parallel import incremental as J
from consensus_specs_tpu.parallel import merkle as JM
from consensus_specs_tpu.utils import jaxtools
from consensus_specs_tpu.utils.ssz.gindex import (
    is_valid_merkle_branch as jax_is_valid_merkle_branch)
import consensus_specs_tpu_torch as T
from consensus_specs_tpu_torch import convert as C
from consensus_specs_tpu_torch.parallel import incremental as P
from consensus_specs_tpu_torch.parallel import merkle as M


def _rand_words(rng, n):
    return rng.randint(0, 2**32, (n, 8), dtype=np.uint64).astype(np.uint32)


def _same_layers(jax_layers, port_layers):
    assert len(jax_layers) == len(port_layers)
    for k, (a, b) in enumerate(zip(jax_layers, port_layers)):
        np.testing.assert_array_equal(C.words_to_numpy(b), np.asarray(a),
                                      err_msg=f"layer {k}")


def _same_forest(jf, pf):
    _same_layers(jf.layers, pf.layers)
    assert pf.root_bytes() == jf.root_bytes()
    np.testing.assert_array_equal(C.words_to_numpy(pf.root()), jf.root())


def _idx(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


# --- the ladder -----------------------------------------------------------------


@pytest.mark.parametrize("n", [0, 1, 2, 63, 64, 65, 1024, 1025, 10_485,
                               16384, 16385, 20_000])
def test_bucket_and_pad_match_jax(n):
    assert P._bucket(n) == J._bucket(n)
    idx = np.arange(n, dtype=np.uint32)[::-1]
    cap = 1 << 18
    np.testing.assert_array_equal(P.pad_dirty_idx(idx, cap).numpy(),
                                  J.pad_dirty_idx(idx, cap).astype(np.int64))


def test_dirty_chunks_from_validators_matches_jax():
    v = np.asarray([9, 0, 3, 4, 7, 1023, 1020, 9], dtype=np.uint32)
    np.testing.assert_array_equal(
        P.dirty_chunks_from_validators(v).numpy(),
        J.dirty_chunks_from_validators(v).astype(np.int64))


# --- builds ---------------------------------------------------------------------


@pytest.mark.parametrize("n_chunks", [1, 5, 64, 256])
def test_build_keeps_every_layer_as_jax(n_chunks):
    words = _rand_words(np.random.RandomState(n_chunks), n_chunks)
    jf = J.MerkleForest(words, 10, n_chunks)
    pf = P.MerkleForest(words, 10, n_chunks, device="cpu")
    assert pf.data_depth == jf.data_depth and pf.capacity == jf.capacity
    _same_forest(jf, pf)


def test_layers_share_one_buffer():
    pf = P.MerkleForest(_rand_words(np.random.RandomState(1), 16), 6, 16,
                        device="cpu")
    base = pf.layers[0].untyped_storage().data_ptr()
    assert all(lay.untyped_storage().data_ptr() == base for lay in pf.layers)
    assert sum(lay.shape[0] for lay in pf.layers) == 31


# --- updates --------------------------------------------------------------------


@pytest.mark.parametrize("dirty", [
    [],                                   # empty: update is a no-op
    [0],                                  # single, first leaf
    [255],                                # single, last leaf
    [7, 7, 7],                            # duplicates (same value)
    [0, 1],                               # sibling pair
    [3, 97, 200, 201],                    # scattered
    list(range(256)),                     # all-dirty
])
def test_update_fixed_sets_match_jax(dirty):
    n = 256
    rng = np.random.RandomState(13)
    words = _rand_words(rng, n)
    jf = J.MerkleForest(words, 10, n)
    pf = P.MerkleForest(words, 10, n, device="cpu")
    uniq = sorted(set(dirty))
    vals = {i: _rand_words(rng, 1)[0] for i in uniq}
    new = np.stack([vals[i] for i in dirty]) if dirty \
        else np.zeros((0, 8), np.uint32)
    idx = np.asarray(dirty, dtype=np.uint32)
    jf.update(idx, new)
    pf.update(idx, new)
    _same_forest(jf, pf)


def test_update_with_sparse_levels_matches_jax(monkeypatch):
    """2**10 chunks, 40 dirty: the 64 rung leaves three sparse levels
    (512, 256 and 128 nodes wide) below a dense tail of seven."""
    n = 1 << 10
    rng = np.random.RandomState(21)
    words = _rand_words(rng, n)
    jf = J.MerkleForest(words, 12, n)
    pf = P.MerkleForest(words, 12, n, device="cpu")
    idx = rng.choice(n, 40, replace=False).astype(np.uint32)
    new = _rand_words(rng, 40)
    calls = {"sparse": 0, "dense": 0}

    def count(kind, fn):
        def wrapped(*a, **k):
            calls[kind] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(P, "update_level_plain",
                        count("sparse", P.update_level_plain))
    monkeypatch.setattr(P, "_hash_level", count("dense", P._hash_level))
    jf.update(idx, new)
    pf.update(idx, new)
    assert calls == {"sparse": 3, "dense": 7}
    _same_forest(jf, pf)


def test_update_dirty_layers_match_jax_function():
    """The module function on raw layer stacks: the JAX one returns new
    layers, the port's updates its own in place."""
    depth = 9
    rng = np.random.RandomState(31)
    leaves = _rand_words(rng, 1 << depth)
    j_layers = J._build_layers(jnp.asarray(leaves), depth)
    p_layers = P.build_layers(C.from_numpy_u32(leaves, "cpu"), depth)
    _same_layers(j_layers, p_layers)
    idx = np.full(64, 1 << depth, dtype=np.uint32)   # sentinel-padded
    idx[:5] = [0, 1, 100, 300, 511]
    new = _rand_words(rng, 64)
    want = J.update_dirty(j_layers, jnp.asarray(idx), jnp.asarray(new), depth)
    got = P.update_dirty(p_layers, _idx(idx), C.from_numpy_u32(new, "cpu"),
                         depth)
    assert got is p_layers
    _same_layers(want, p_layers)


def test_update_randomized_sequence_matches_jax():
    n = 512
    rng = np.random.RandomState(29)
    words = _rand_words(rng, n)
    jf = J.MerkleForest(words, 12, n)
    pf = P.MerkleForest(words, 12, n, device="cpu")
    for _ in range(5):
        m = int(rng.randint(1, 65))
        idx = rng.choice(n, m, replace=False).astype(np.uint32)
        new = _rand_words(rng, m)
        jf.update(idx, new)
        pf.update(idx, new)
        _same_forest(jf, pf)


def test_update_accepts_sentinel_padding():
    n = 64
    rng = np.random.RandomState(41)
    words = _rand_words(rng, n)
    jf = J.MerkleForest(words, 8, n)
    pf = P.MerkleForest(words, 8, n, device="cpu")
    rung = P._bucket(3)
    idx = np.full((rung,), pf.capacity, dtype=np.uint32)
    idx[:3] = [1, 8, 63]
    new = np.zeros((rung, 8), dtype=np.uint32)
    new[:3] = _rand_words(rng, 3)
    jf.update(idx, jnp.asarray(new))
    pf.update(_idx(idx), C.from_numpy_u32(new, "cpu"))
    _same_forest(jf, pf)


def test_update_refuses_more_leaf_rows_than_indices():
    pf = P.MerkleForest(np.zeros((8, 8), np.uint32), 4, 8, device="cpu")
    with pytest.raises(ValueError):
        pf.update([1], np.zeros((65, 8), np.uint32))
    with pytest.raises(ValueError):
        P.MerkleForest(np.zeros((17, 8), np.uint32), 4, 17, device="cpu")


# --- balance chunks ---------------------------------------------------------------


def test_gather_balance_chunks_matches_jax():
    """Chunk 1024 holds the last 3 values and one past N; chunk 1025 and
    the sentinel 2**18 lie past N entirely: their words are zero."""
    rng = np.random.RandomState(3)
    bal = rng.randint(0, 2**63, 4099, dtype=np.uint64) * np.uint64(2)
    chunks = np.asarray([0, 3, 1023, 1024, 1025, 1 << 18], dtype=np.uint32)
    want = np.asarray(J._gather_balance_chunks(jnp.asarray(bal),
                                               jnp.asarray(chunks)))
    got = P.gather_balance_chunks(C.from_numpy_u64(bal, "cpu"), _idx(chunks))
    np.testing.assert_array_equal(C.words_to_numpy(got), want)
    assert not want[4:].any()
    np.testing.assert_array_equal(
        C.words_to_numpy(P.dirty_balance_leaves(C.from_numpy_u64(bal, "cpu"),
                                                _idx(chunks))), want)


def test_balances_forest_matches_jax_and_updates():
    n = 100                              # 25 chunks, padded to 32
    rng = np.random.RandomState(17)
    bal = rng.randint(0, 2**63, n, dtype=np.uint64)
    jf = J.balances_forest(bal, n, limit_depth=8)
    pf = P.balances_forest(bal, n, limit_depth=8, device="cpu")
    _same_forest(jf, pf)
    dirty = np.asarray([0, 3, 42, 99], dtype=np.uint32)
    bal = bal.copy()
    bal[dirty] = rng.randint(0, 2**63, 4, dtype=np.uint64)
    chunks = J.dirty_chunks_from_validators(dirty)
    jroot = J.merkleize_dirty(jf, chunks, J.dirty_balance_leaves(
        jnp.asarray(bal), chunks))
    pchunks = P.dirty_chunks_from_validators(dirty)
    proot = P.merkleize_dirty(pf, pchunks, P.dirty_balance_leaves(
        C.from_numpy_u64(bal, "cpu"), pchunks))
    np.testing.assert_array_equal(C.words_to_numpy(proot), jroot)
    _same_forest(jf, pf)


# --- proof paths and proofs ---------------------------------------------------------


@pytest.mark.parametrize("n_chunks,idx", [
    (1, [0, 0, 5]),                       # depth 0: (M, 0, 8) paths
    (48, [0, 1, 47, 63, 64, 1000]),       # depth 6, indices past capacity
])
def test_gather_proof_paths_matches_jax(n_chunks, idx):
    words = _rand_words(np.random.RandomState(n_chunks), n_chunks)
    jf = J.MerkleForest(words, 8, n_chunks)
    pf = P.MerkleForest(words, 8, n_chunks, device="cpu")
    d = jf.data_depth
    j_leaves, j_paths = J.gather_proof_paths(
        jf.layers, jnp.asarray(np.asarray(idx, np.uint32)), d)
    p_leaves, p_paths = P.gather_proof_paths(pf.layers, _idx(idx), d)
    assert tuple(p_paths.shape) == (len(idx), d, 8)
    np.testing.assert_array_equal(C.words_to_numpy(p_leaves),
                                  np.asarray(j_leaves))
    np.testing.assert_array_equal(C.words_to_numpy(p_paths),
                                  np.asarray(j_paths))


def test_proofs_match_jax_and_verify_on_both_sides():
    n = 96
    rng = np.random.RandomState(5)
    words = _rand_words(rng, n)
    jf = J.MerkleForest(words, 9, 4 * n)
    pf = P.MerkleForest(words, 9, 4 * n, device="cpu")
    root = pf.root_bytes()
    assert root == jf.root_bytes()
    indices = [0, 1, 50, n - 1, 50]
    proofs = P.emit_proofs(pf, indices)
    assert [tuple(p) for p in proofs] == [tuple(p) for p in
                                         J.emit_proofs(jf, indices)]
    for p in proofs:
        assert p.depth == 10 and p.gindex == (2 << 9) + p.index
        assert P.verify_proof(p, root) and J.verify_proof(p, root)
        bad = bytes([p.leaf[0] ^ 1]) + p.leaf[1:]
        assert not P.is_valid_merkle_branch(bad, p.branch, p.depth,
                                            p.index, root)
        assert not jax_is_valid_merkle_branch(bad, p.branch, p.depth,
                                              p.index, root)
    assert P.emit_proofs(pf, []) == []
    with pytest.raises(ValueError):
        pf.emit_proofs([n])


def test_proofs_track_updates_and_reject_stale_roots():
    n = 64
    rng = np.random.RandomState(8)
    pf = P.MerkleForest(_rand_words(rng, n), 8, n, device="cpu")
    old_root = pf.root_bytes()
    old = pf.emit_proofs([9])[0]
    pf.update([9], _rand_words(rng, 1))
    new_root = pf.root_bytes()
    new = pf.emit_proofs([9])[0]
    assert new_root != old_root and new.leaf != old.leaf
    assert P.verify_proof(new, new_root) and J.verify_proof(new, new_root)
    assert not P.verify_proof(old, new_root)
    assert not J.verify_proof(old, new_root)
    assert not P.verify_proof(new, old_root)


# --- state carried across ---------------------------------------------------------


def test_from_layers_of_a_jax_forest_then_one_update_each():
    n = 200
    rng = np.random.RandomState(12)
    jf = J.MerkleForest(_rand_words(rng, n), 10, n)
    pf = P.MerkleForest.from_layers([np.asarray(lay) for lay in jf.layers],
                                    10, n, n, device="cpu")
    _same_forest(jf, pf)
    idx = np.asarray([0, 5, 199, 128], dtype=np.uint32)
    new = _rand_words(rng, 4)
    jf.update(idx, new)
    pf.update(idx, new)
    _same_forest(jf, pf)
    with pytest.raises(ValueError):
        P.MerkleForest.from_layers([np.zeros((4, 8), np.uint32),
                                    np.zeros((1, 8), np.uint32)], 4, 4, 4,
                                   device="cpu")


# --- K3's gather mode ---------------------------------------------------------------


def test_records_root_gather_mode_matches_jax():
    n = 64
    reg = C.synthetic_registry(n, seed=4)
    reg["exit_epoch"][::3] = 77
    reg["slashed"][::5] = True
    pk, cred = C.synthetic_leaf_words(n)
    idx = np.asarray([0, 63, 17, 17, 64, 1 << 20, 5], dtype=np.uint32)
    safe = np.minimum(idx, n - 1)
    want = np.asarray(JM.validator_records_root(
        JM.ValidatorLeaves(jnp.asarray(pk[safe]), jnp.asarray(cred[safe])),
        *(jnp.asarray(reg[f][safe]) for f in (
            "effective_balance", "slashed", "activation_eligibility_epoch",
            "activation_epoch", "exit_epoch", "withdrawable_epoch"))))
    r = C.registry_to_torch(reg, "cpu")
    got = M.validator_records_root(
        C.leaves_to_torch(pk, cred, "cpu"), r.effective_balance, r.slashed,
        r.activation_eligibility_epoch, r.activation_epoch, r.exit_epoch,
        r.withdrawable_epoch, index=_idx(idx))
    np.testing.assert_array_equal(C.words_to_numpy(got), want)


# --- the composed incremental step (bench.py worker_epoch) --------------------------


N_STEP = 1 << 12


@pytest.fixture(scope="module")
def bench_step():
    """bench.py worker_epoch's step at 2**12 validators on the JAX side:
    inputs, and the outputs and forest layers after one step."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jaxtools, "enable_compile_cache", lambda *a, **k: None)
    try:
        graft = importlib.import_module("__graft_entry__")
    finally:
        mp.undo()
    n = N_STEP
    params = EpochParams.from_spec(build_spec("phase0", "mainnet"))
    reg = graft._synthetic_registry(n)
    sc = EpochScalars(current_epoch=np.uint64(100_000),
                      finality_delay=np.uint64(2),
                      slashings_sum=np.uint64(32_000_000_000))
    rng = np.random.RandomState(7)
    pk = rng.randint(0, 2**32, (n, 8), dtype=np.uint64).astype(np.uint32)
    cred = rng.randint(0, 2**32, (n, 8), dtype=np.uint64).astype(np.uint32)
    m = max(1, int(0.01 * n))
    dirty = np.sort(rng.choice(n, m, replace=False)).astype(np.uint32)
    mask = np.zeros(n, dtype=bool)
    mask[dirty] = True

    @jax.jit
    def sweep_step(reg, sc, mask):
        new_bal, new_eff = epoch_sweep(reg, sc, params, axis_name=None)
        return (jnp.where(mask, new_bal, reg.balance),
                jnp.where(mask, new_eff, reg.effective_balance))

    @jax.jit
    def dirty_record_roots(eff, slashed, aee, ae, ee, we, pk, cr, idx):
        safe = jnp.minimum(idx, jnp.uint32(eff.shape[0] - 1))
        return JM.validator_records_root(
            ValidatorLeaves(pk[safe], cr[safe]), eff[safe], slashed[safe],
            aee[safe], ae[safe], ee[safe], we[safe])

    rec_all = JM.validator_records_root(
        ValidatorLeaves(jnp.asarray(pk), jnp.asarray(cred)),
        reg.effective_balance, reg.slashed, reg.activation_eligibility_epoch,
        reg.activation_epoch, reg.exit_epoch, reg.withdrawable_epoch)
    bal_forest = J.balances_forest(reg.balance, n)
    reg_forest = J.registry_forest(np.asarray(rec_all), n)
    chunk_idx_p = J.pad_dirty_idx(J.dirty_chunks_from_validators(dirty),
                                  bal_forest.capacity)
    val_idx_p = J.pad_dirty_idx(dirty, reg_forest.capacity)
    bal, eff = sweep_step(reg, sc, mask)
    leaves = J.dirty_balance_leaves(bal, jnp.asarray(chunk_idx_p))
    rec = dirty_record_roots(eff, reg.slashed,
                             reg.activation_eligibility_epoch,
                             reg.activation_epoch, reg.exit_epoch,
                             reg.withdrawable_epoch, jnp.asarray(pk),
                             jnp.asarray(cred), jnp.asarray(val_idx_p))
    bal_root = J.merkleize_dirty(bal_forest, chunk_idx_p, leaves)
    reg_root = J.merkleize_dirty(reg_forest, val_idx_p, rec)
    want = dict(bal=np.asarray(bal), eff=np.asarray(eff), bal_root=bal_root,
                reg_root=reg_root,
                bal_layers=[np.asarray(x) for x in bal_forest.layers],
                reg_layers=[np.asarray(x) for x in reg_forest.layers])
    return params, reg, sc, (pk, cred, dirty), want


def _port_step(bench_step, **kw):
    params, reg, sc, (pk, cred, dirty), _ = bench_step
    return T.IncrementalEpochStep(
        T.params_from_jax(params._asdict()),
        C.registry_to_torch(reg._asdict(), "cpu"), C.scalars_to_torch(sc),
        C.leaves_to_torch(pk, cred, "cpu"), dirty, device="cpu", **kw)


def test_incremental_step_matches_jax(bench_step):
    want = bench_step[-1]
    step = _port_step(bench_step)
    assert int((step.validator_idx < N_STEP).sum()) == 40
    assert step.chunk_idx.shape == (64,)
    bal, eff, bal_root, reg_root = step()
    np.testing.assert_array_equal(C.u64_to_numpy(bal), want["bal"])
    np.testing.assert_array_equal(C.u64_to_numpy(eff), want["eff"])
    np.testing.assert_array_equal(C.words_to_numpy(bal_root),
                                  want["bal_root"])
    np.testing.assert_array_equal(C.words_to_numpy(reg_root),
                                  want["reg_root"])
    _same_layers(want["bal_layers"], step.balances_forest.layers)
    _same_layers(want["reg_layers"], step.registry_forest.layers)
    # the incremental roots equal the full rebuild of slice 1 over the
    # same arrays
    r = step.reg
    full_rec = M.validator_records_root(
        step.leaves, eff, r.slashed, r.activation_eligibility_epoch,
        r.activation_epoch, r.exit_epoch, r.withdrawable_epoch)
    assert torch.equal(bal_root, M.balances_list_root(bal, N_STEP))
    assert torch.equal(reg_root, M.validator_registry_root(full_rec, N_STEP))
    # a second step on the same inputs lands on the same roots
    again = step()
    assert torch.equal(again[2], bal_root) and torch.equal(again[3], reg_root)


def test_bench_recipe_and_plain_flag(bench_step):
    """`convert.incremental_step_inputs` is bench's draw, and `plain=True`
    on the CPU is the same step."""
    pk, cred, dirty = bench_step[3]
    got = C.incremental_step_inputs(N_STEP)
    np.testing.assert_array_equal(got[0], pk)
    np.testing.assert_array_equal(got[1], cred)
    np.testing.assert_array_equal(got[2], dirty.astype(np.int64))
    a = _port_step(bench_step)()
    b = _port_step(bench_step, plain=True)()
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_incremental_step_checks_its_inputs(bench_step, monkeypatch):
    params, reg, sc, (pk, cred, _), _ = bench_step
    args = (T.params_from_jax(params._asdict()),
            C.registry_to_torch(reg._asdict(), "cpu"),
            C.scalars_to_torch(sc), C.leaves_to_torch(pk, cred, "cpu"))
    with pytest.raises(ValueError, match="dirty"):
        T.IncrementalEpochStep(*args, [0, N_STEP], device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        T.IncrementalEpochStep(*args, [0])
    with pytest.raises(RuntimeError, match="CUDA"):
        P.MerkleForest(np.zeros((4, 8), np.uint32), 4, 4)
