"""The port's `ShardedMerkleForest` (`parallel/incremental.py`, the plain
K2, K4 and K6 on each shard) against the JAX package's
`ShardedMerkleForest` on the conftest's 8 virtual CPU devices, at D = 1,
2 and 4 shards of a virtual CPU mesh.  Tolerance zero: roots, proof
leaves and branches equal byte for byte.

- the root of a balances list that does not fill its tree, against JAX's
  and the single forest's;
- a dirty update touching some shards (duplicates, a shard boundary),
  then the root and a batch of proofs across every shard, against JAX's;
  each proof verifies against the root;
- an update dispatches only to the shards it touches;
- `convert.sharded_forest_to_torch` carries JAX's shard layers across,
  and the carried forest then updates as JAX's does."""

import numpy as np
import pytest
import torch

from consensus_specs_tpu.parallel import incremental as JI
from consensus_specs_tpu_torch import convert as C
from consensus_specs_tpu_torch import parallel as TP
from consensus_specs_tpu_torch.parallel import incremental as TI

N = 1000                  # 250 chunks: a 256-leaf tree, not full
LIMIT = 38


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def balances():
    return np.random.RandomState(11).randint(
        0, 2**40, N).astype(np.uint64)


def _jax_root(forest) -> bytes:
    return np.asarray(forest.root(), dtype=np.uint32).astype(">u4").tobytes()


def _dirty(rng, cap, shards):
    local = cap // shards
    idx = np.concatenate([rng.choice(local, 3, replace=False),
                          [local - 1, local, 0, 0]]) % cap
    idx = idx[idx < 250]
    words = rng.randint(0, 2**32, (len(idx), 8),
                        dtype=np.uint64).astype(np.uint32)
    words[idx == 0] = words[np.argmax(idx == 0)]     # duplicates agree
    return idx.astype(np.int64), words


def _same_proofs(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.index == w.index and g.gindex == w.gindex
        assert g.leaf == w.leaf and tuple(g.branch) == tuple(w.branch)


@pytest.mark.parametrize("d", [1, 2, 4])
def test_sharded_forest_matches_jax(balances, d):
    jf = JI.sharded_balances_forest(balances, N, LIMIT, n_shards=d)
    tf = TP.sharded_balances_forest(balances, N, LIMIT,
                                    devices=["cpu"] * d)
    assert tf.n_shards == d and tf.local_depth == jf.local_depth
    assert tf.root_bytes() == _jax_root(jf)
    assert tf.root_bytes() == TP.balances_forest(
        balances, N, LIMIT, device="cpu").root_bytes()

    idx, words = _dirty(np.random.RandomState(d), tf.capacity, d)
    jf.update(idx.astype(np.uint32), words)
    tf.update(idx, words)
    root = tf.root_bytes()
    assert root == _jax_root(jf)

    wanted = sorted({0, 1, 63, 64, 127, 128, 200, 249} | set(idx.tolist()))
    got = tf.emit_proofs(wanted)
    _same_proofs(got, jf.emit_proofs(wanted))
    assert all(TP.verify_proof(p, root) for p in got)


def test_update_dispatches_only_to_touched_shards(balances, monkeypatch):
    tf = TP.sharded_balances_forest(balances, N, LIMIT, devices=["cpu"] * 4)
    calls = []
    real = TI.update_dirty
    monkeypatch.setattr(TI, "update_dirty", lambda layers, *a, **k: (
        calls.append(next(i for i, s in enumerate(tf.shard_layers)
                          if s is layers)), real(layers, *a, **k))[1])
    words = np.ones((3, 8), np.uint32)
    tf.update([65, 70, 200], words)                 # shards 1 and 3
    assert calls == [1, 3]
    tf.update([], np.zeros((0, 8), np.uint32))
    tf.update([300], np.ones((1, 8), np.uint32))    # past the capacity
    assert calls == [1, 3]


@pytest.mark.parametrize("d", [2, 4])
def test_sharded_forest_carried_across_from_jax(balances, d):
    jf = JI.sharded_balances_forest(balances, N, LIMIT, n_shards=d)
    tf = C.sharded_forest_to_torch(jf, ["cpu"] * d)
    assert tf.root_bytes() == _jax_root(jf)
    idx, words = _dirty(np.random.RandomState(7), tf.capacity, d)
    jf.update(idx.astype(np.uint32), words)
    tf.update(idx, words)
    assert tf.root_bytes() == _jax_root(jf)
    _same_proofs(tf.emit_proofs([3, 130]), jf.emit_proofs([3, 130]))


def test_sharded_forest_rejects_what_it_cannot_hold():
    with pytest.raises(ValueError, match="power-of-two"):
        TP.ShardedMerkleForest(np.zeros((8, 8), np.uint32), 10, 8,
                               devices=["cpu"] * 3)
    tf = TP.ShardedMerkleForest(np.zeros((8, 8), np.uint32), 10, 8,
                                devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="outside"):
        tf.emit_proofs([8])
