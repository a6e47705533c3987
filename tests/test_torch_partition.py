"""The port's partition-rule registry, `build_mesh` and collectives
(`consensus_specs_tpu_torch.parallel.partition`, `.collectives`) against
`consensus_specs_tpu.parallel.partition` on the conftest's 8 virtual CPU
devices.  Tolerance zero: markers, device lists and integer sums are
compared for equality.

- the rule matcher against JAX's `match_partition_rules` on the same
  trees (the port's SHARD / REPLICATE for JAX's P("data") / P()),
  including rule precedence, the scalar skip and the unmatched-path
  error; the step's specs against JAX's `epoch_step_specs`;
- `mesh_rung` and `build_mesh` (prefixes, `device_ids` subsets, the
  power-of-two check) against JAX's, and `build_mesh()` raising without
  a card;
- `shard_tree` / `gather_tree` round trips, and the collectives exact on
  uint64 bit patterns, never aliasing on a virtual mesh."""

import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from consensus_specs_tpu.parallel import EpochScalars as JScalars
from consensus_specs_tpu.parallel import RegistryArrays as JRegistry
from consensus_specs_tpu.parallel import partition as JP
from consensus_specs_tpu_torch import convert as C
from consensus_specs_tpu_torch.parallel import collectives as CO
from consensus_specs_tpu_torch.parallel import partition as TP


def _as_marker(spec):
    return TP.SHARD if spec == P("data") else TP.REPLICATE


def _same_markers(jax_tree, torch_tree):
    j = [(n, _as_marker(s)) for n, s in JP.named_tree_leaves(jax_tree)]
    assert j == TP.named_tree_leaves(torch_tree)


def _tree(u64, words):
    return {"reg": JRegistry(*([u64] * len(JRegistry._fields))),
            "scalars": JScalars(np.uint64(1), np.uint64(2), np.uint64(3)),
            "leaves": [{"pubkey_root": words},
                       ({"credentials": words}, {"length": np.uint64(8)})],
            "record_roots": words, "mask": np.zeros(4, bool),
            "one": np.zeros((1,), np.uint64)}


def test_rule_matcher_matches_jax_on_the_epoch_state():
    tree = _tree(np.zeros(4, np.uint64), np.zeros((4, 8), np.uint32))
    ttree = _tree(torch.zeros(4, dtype=torch.int64),
                  torch.zeros((4, 8), dtype=torch.int32))
    _same_markers(JP.match_partition_rules(JP.EPOCH_STATE_RULES, tree),
                  TP.match_partition_rules(TP.EPOCH_STATE_RULES, ttree))
    assert ([n for n, _ in JP.named_tree_leaves(tree)]
            == [n for n, _ in TP.named_tree_leaves(ttree)])


def test_rule_precedence_first_match_wins():
    tree = {"a": {"balance": np.zeros(8, np.uint64)},
            "b": {"balance": np.zeros(8, np.uint64)}}
    ttree = {"a": {"balance": torch.zeros(8)},
             "b": {"balance": torch.zeros(8)}}
    jrules = ((r"^a/balance$", P()), (r"balance$", P("data")))
    trules = ((r"^a/balance$", TP.REPLICATE), (r"balance$", TP.SHARD))
    _same_markers(JP.match_partition_rules(jrules, tree),
                  TP.match_partition_rules(trules, ttree))
    got = TP.match_partition_rules(trules, ttree)
    assert got == {"a": {"balance": TP.REPLICATE},
                   "b": {"balance": TP.SHARD}}


def test_scalars_never_shard_and_unmatched_paths_raise():
    rules = ((r"x$", TP.SHARD),)
    assert TP.match_partition_rules(
        rules, {"x": torch.zeros(()), "y": 3, "z": torch.zeros(1)}) == {
            "x": TP.REPLICATE, "y": TP.REPLICATE, "z": TP.REPLICATE}
    with pytest.raises(ValueError, match="no partition rule"):
        JP.match_partition_rules(((r"x$", P("data")),),
                                 {"unknown": np.zeros(4)})
    with pytest.raises(ValueError, match="no partition rule"):
        TP.match_partition_rules(rules, {"unknown": torch.zeros(4)})


def test_epoch_step_specs_match_jax():
    j_in, j_out = JP.epoch_step_specs()
    t_in, t_out = TP.epoch_step_specs()
    for j, t in zip(j_in, t_in):
        if isinstance(j, P):
            assert _as_marker(j) == t
        else:
            _same_markers(j, t)
    assert [_as_marker(s) for s in j_out] == list(t_out)


@pytest.mark.parametrize("n", list(range(1, 18)) + [1023, 1024, 1025])
def test_mesh_rung_matches_jax(n):
    assert TP.mesh_rung(n) == JP.mesh_rung(n)


@pytest.fixture
def four_cards(monkeypatch):
    """`build_mesh` on a machine it is told has four cards (no card is
    touched: the mesh is a tuple of `torch.device`s)."""
    monkeypatch.setattr(TP, "available_devices", lambda: 4)


@pytest.mark.parametrize("kw", [dict(), dict(n_devices=2),
                                dict(device_ids=(1, 3)),
                                dict(device_ids=(2,)),
                                dict(n_devices=4, require_pow2=True)])
def test_build_mesh_subsets_match_jax(four_cards, kw):
    jax_kw = dict(kw)
    if not kw:
        jax_kw = dict(n_devices=4)
    want = [d.id for d in JP.build_mesh(**jax_kw).devices.flat]
    mesh = TP.build_mesh(**kw)
    assert [d.index for d in mesh.devices] == want
    assert all(d.type == "cuda" for d in mesh.devices)
    assert mesh.axis == "data" and mesh.size == len(want)


def test_build_mesh_rejects_what_jax_rejects(four_cards):
    with pytest.raises(AssertionError):
        JP.build_mesh(n_devices=3, require_pow2=True)
    with pytest.raises(ValueError, match="power of two"):
        TP.build_mesh(n_devices=3, require_pow2=True)
    with pytest.raises(ValueError):
        TP.build_mesh(n_devices=5)
    with pytest.raises(ValueError):
        TP.build_mesh(device_ids=(0, 4))


def test_build_mesh_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(TP, "available_devices", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TP.build_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TP.build_mesh(n_devices=1)
    mesh = TP.build_mesh(devices=["cpu"] * 4, require_pow2=True)
    assert mesh.devices == (torch.device("cpu"),) * 4


@pytest.mark.parametrize("d", [1, 2, 4, 8])
def test_shard_tree_round_trip(d):
    reg = C.registry_to_torch(C.synthetic_registry(64, seed=4), "cpu")
    mesh = TP.build_mesh(devices=["cpu"] * d)
    tree = {"reg": reg, "sc": (5, 6, 7), "length": 64,
            "pubkey_root": torch.arange(64 * 8, dtype=torch.int32
                                        ).reshape(64, 8)}
    shards = TP.shard_tree(mesh, tree)
    assert len(shards) == d
    assert shards[-1]["reg"].balance.shape == (64 // d,)
    assert torch.equal(shards[1 % d]["reg"].balance,
                       reg.balance[(1 % d) * 64 // d:(1 % d + 1) * 64 // d])
    back = TP.gather_tree(shards)
    for f in reg._fields:
        assert torch.equal(getattr(back["reg"], f), getattr(reg, f))
    assert back["sc"] == (5, 6, 7) and back["length"] == 64
    assert torch.equal(back["pubkey_root"], tree["pubkey_root"])
    # copies, not views: writing a shard leaves the tree and the others
    shards[0]["reg"].balance.fill_(-1)
    assert not torch.equal(reg.balance[:64 // d],
                           shards[0]["reg"].balance)


def test_collectives_are_exact_on_u64_bit_patterns():
    rng = np.random.RandomState(0)
    parts = rng.randint(0, 2**64, (4, 12), dtype=np.uint64)
    parts[:, 0] = np.uint64(2**64 - 1)                  # wraps
    t = [C.from_numpy_u64(p, "cpu") for p in parts]
    want = parts.sum(axis=0, dtype=np.uint64)
    for got in CO.all_reduce_sum(t):
        assert (C.u64_to_numpy(got) == want).all()
    for d, got in enumerate(CO.reduce_scatter_sum(t)):
        assert (C.u64_to_numpy(got) == want[3 * d:3 * (d + 1)]).all()
    for got in CO.all_gather(t):
        assert (C.u64_to_numpy(got) == parts).all()
    with pytest.raises(ValueError):
        CO.reduce_scatter_sum([torch.zeros(5, dtype=torch.int64)] * 2)


def test_virtual_mesh_collectives_never_alias():
    """On a virtual mesh every shard shares one device: each output must
    be its own buffer, so a kernel writing one in place changes nothing
    else."""
    t = [torch.full((8,), d, dtype=torch.int64) for d in range(4)]
    outs = (CO.all_gather(t) + CO.all_reduce_sum(t)
            + CO.reduce_scatter_sum(t) + [CO.gather(t, "cpu")])
    ptrs = {o.data_ptr() for o in outs}
    assert len(ptrs) == len(outs)
    assert not ptrs & {p.data_ptr() for p in t}
    before = [o.clone() for o in outs]
    outs[0].fill_(99)
    assert all(torch.equal(o, b) for o, b in zip(outs[1:], before[1:]))
    assert [int(p[0]) for p in t] == [0, 1, 2, 3]
