"""Slice 7 of the port, fork choice (`consensus_specs_tpu_torch/forkchoice/`)
against the JAX package, on the CPU (the plain versions of K21-K23).

The arithmetic is exact integer, so the tolerance is zero: accept masks,
live latest-message entries, live weights, heads, accept counts and
fingerprints must be equal.  The one exception is each array's dummy slot
(index == its rung), which masked rows address and whose value is left
unspecified by XLA, CUDA and `index_put_` alike; every array comparison
leaves it out.  The JAX kernels run with `jax_enable_x64` (the conftest
turns it on); without it they truncate int64 to int32.
"""

import itertools

import numpy as np
import pytest
import torch

from consensus_specs_tpu.forkchoice import ProtoArrayStore as JaxStore
from consensus_specs_tpu.forkchoice import bridge as jax_bridge
from consensus_specs_tpu.forkchoice import kernels as JK
from consensus_specs_tpu.forkchoice import oracle as jax_oracle
from consensus_specs_tpu.forkchoice import synthetic as jax_synthetic
from consensus_specs_tpu.models.builder import build_spec
from consensus_specs_tpu_torch import convert as CV
from consensus_specs_tpu_torch.forkchoice import (FC_BATCH_STEPS,
                                                  FC_BLOCK_STEPS,
                                                  FC_VALIDATOR_STEPS,
                                                  ProtoArrayStore, fc_rung)
from consensus_specs_tpu_torch.forkchoice import bridge as port_bridge
from consensus_specs_tpu_torch.forkchoice import kernels as K
from consensus_specs_tpu_torch.forkchoice import oracle as port_oracle
from consensus_specs_tpu_torch.forkchoice import synthetic as port_synthetic

GWEI_32 = 32 * 10 ** 9
RUNGS = [(64, 256, 64), (1024, 4096, 1024)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the plain versions are many small ops, and
    parallel test workers must not oversubscribe the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def spec():
    return build_spec("phase0", "minimal")


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


# --- the kernels' plain versions against JAX's jitted kernels ---------------


@pytest.mark.parametrize("nb_pad,v_pad,batch", RUNGS)
def test_apply_plain_equals_jax(nb_pad, v_pad, batch):
    import jax.numpy as jnp

    x = port_synthetic.kernel_inputs(nb_pad, v_pad, batch, seed=nb_pad)
    names = ("val_idx", "att_epoch", "att_block", "lm_epoch", "lm_block",
             "balance", "can_update", "node_weight")
    j_e, j_b, j_w, j_acc = JK._apply_kernel(batch, v_pad, nb_pad)(
        *(jnp.asarray(x[k]) for k in names))
    t = {k: _t(x[k]) for k in names}
    acc = K.fc_apply_plain(*(t[k] for k in names))
    assert torch.equal(acc, torch.from_numpy(np.array(j_acc)))
    assert (t["lm_epoch"].numpy()[:v_pad] == np.asarray(j_e)[:v_pad]).all()
    assert (t["lm_block"].numpy()[:v_pad] == np.asarray(j_b)[:v_pad]).all()
    assert (t["node_weight"].numpy()[:nb_pad]
            == np.asarray(j_w)[:nb_pad]).all()
    acc = acc.numpy()
    # the repeated validator at one epoch: the earliest row wins
    assert acc[0] and not acc[1:10].any()
    # padded rows and equivocators never accept
    assert not acc[batch - batch // 8:].any()
    assert not acc[~x["can_update"][x["val_idx"]]].any()
    assert 0 < acc.sum() < batch - batch // 8


@pytest.mark.parametrize("nb_pad,v_pad,batch", RUNGS)
def test_refresh_plain_equals_jax(nb_pad, v_pad, batch):
    import jax.numpy as jnp

    x = port_synthetic.kernel_inputs(nb_pad, v_pad, batch, seed=nb_pad + 1)
    want = np.asarray(JK._refresh_kernel(v_pad, nb_pad)(
        jnp.asarray(x["lm_block"]), jnp.asarray(x["balance"])))
    got = K.fc_refresh_plain(_t(x["lm_block"]), _t(x["balance"]), nb_pad)
    assert got.shape == (nb_pad + 1,)
    assert (got.numpy()[:nb_pad] == want[:nb_pad]).all()
    assert (got.numpy()[:nb_pad] == x["node_weight"][:nb_pad]).all()


def _head_both(x, nb_pad, weight, boost_idx, boost_amt):
    import jax.numpy as jnp

    j = JK._head_kernel(nb_pad)(
        jnp.asarray(x["parent"]), jnp.asarray(weight), jnp.int32(boost_idx),
        jnp.int64(boost_amt), jnp.asarray(x["real"]),
        jnp.zeros(nb_pad + 1, dtype=jnp.int64),
        jnp.asarray(x["block_epoch"]), jnp.asarray(x["je"]),
        jnp.asarray(x["uje"]), jnp.asarray(x["fin_ok"]),
        jnp.asarray(x["limbs"].astype(np.uint32)), jnp.int64(x["sj"]),
        jnp.int64(x["sf"]), jnp.int64(x["cur"]),
        jnp.int32(x["justified_idx"]))
    p = K.fc_head_plain(
        _t(x["parent"]), _t(weight), boost_idx, boost_amt, _t(x["real"]),
        _t(x["block_epoch"]), _t(x["je"]), _t(x["uje"]), _t(x["fin_ok"]),
        _t(x["limbs"]), x["sj"], x["sf"], x["cur"], x["justified_idx"])
    assert p.dtype == torch.int32 and p.shape == ()
    return int(j), int(p)


@pytest.mark.parametrize("nb_pad,v_pad,batch", RUNGS)
@pytest.mark.parametrize("variant", ["weights", "boost", "root_words"])
def test_head_plain_equals_jax(nb_pad, v_pad, batch, variant):
    x = port_synthetic.kernel_inputs(nb_pad, v_pad, batch, seed=nb_pad + 2)
    weight, boost_idx, boost_amt = x["node_weight"], nb_pad, 0
    if variant == "boost":
        boost_idx, boost_amt = x["boost_idx"], x["boost_amt"]
    if variant == "root_words":
        weight = np.zeros_like(weight)
    j, p = _head_both(x, nb_pad, weight, boost_idx, boost_amt)
    assert j == p
    if variant == "root_words":
        # block 1 (first word 2**31) over block 2 (2**31 - 1), then block
        # 4 over block 3 on the fourth word: int32 bit patterns would flip
        # both
        assert p == 4


def test_head_viability_prunes_the_heavier_branch():
    """A heavier leaf with a stale voting source drops out of the walk."""
    nb_pad = 64
    x = port_synthetic.kernel_inputs(nb_pad, 256, 64, seed=7)
    x["parent"][:] = nb_pad
    x["parent"][1:3] = 0
    x["real"][:] = False
    x["real"][:3] = True
    x["je"][2] = x["uje"][2] = x["sj"] - 3        # stale
    x["block_epoch"][1:3] = x["cur"]
    weight = np.zeros(nb_pad + 1, dtype=np.int64)
    weight[1], weight[2] = GWEI_32, 5 * GWEI_32
    j, p = _head_both(x, nb_pad, weight, nb_pad, 0)
    assert j == p == 1
    x["je"][2] = x["uje"][2] = x["sj"]
    j, p = _head_both(x, nb_pad, weight, nb_pad, 0)
    assert j == p == 2


def test_fc_rung_ladders_equal_jax():
    assert (FC_BLOCK_STEPS, FC_VALIDATOR_STEPS, FC_BATCH_STEPS) == (
        JK.FC_BLOCK_STEPS, JK.FC_VALIDATOR_STEPS, JK.FC_BATCH_STEPS)
    for n in (0, 1, 2, 63, 64, 65, 1000, 1024, 1025, 5000, 40000, 2 ** 21):
        for steps in (FC_BLOCK_STEPS, FC_VALIDATOR_STEPS, FC_BATCH_STEPS):
            assert fc_rung(n, steps) == JK.fc_rung(n, steps)
        # 2**rounds jumps cover the longest chain a rung holds
        assert 2 ** K.head_rounds(fc_rung(n)) >= fc_rung(n) - 1


def test_wrappers_take_the_plain_version_on_the_cpu(monkeypatch):
    """On CPU tensors the wrappers run the plain versions, never the
    kernels (whose wrappers raise on CPU tensors)."""
    def boom(*a, **k):
        raise AssertionError("a kernel was launched for CPU tensors")

    for name in ("fc_apply_kernel", "fc_refresh_kernel", "fc_head_kernel"):
        monkeypatch.setattr(K, name, boom)
    st, _ = port_synthetic.synthetic_store(40, 300, device="cpu")
    stream = port_synthetic.attestation_stream(st.roots, 300, 64)
    assert st.apply_attestations(*next(stream)) > 0
    assert st.get_head() in st.roots
    monkeypatch.undo()
    x = port_synthetic.kernel_inputs(64, 256, 64)
    with pytest.raises(ValueError, match="CUDA"):
        K.fc_refresh_kernel(_t(x["lm_block"]), _t(x["balance"]), 64)


# --- the store against the JAX store and the spec oracle --------------------


def _random_store(seed, n_blocks=18, n_validators=40):
    """The JAX suite's randomized parity generator
    (tests/test_forkchoice.py `_random_store`), on the JAX store."""
    rng = np.random.RandomState(seed)
    anchor = bytes([seed % 256]) + b"\x00" * 31
    st = JaxStore(anchor, 0, slots_per_epoch=8, preset="minimal")
    roots = [anchor]
    for i in range(1, n_blocks):
        parent = roots[rng.randint(0, i)]
        slot = st.slots[st.root_index[parent]] + 1 + rng.randint(0, 2)
        root = bytes(rng.randint(0, 256, 32, dtype=np.uint8))
        st.add_block(root, parent, slot, 0, 0)
        roots.append(root)
    eb = np.full(n_validators, GWEI_32, dtype=np.int64)
    eb[rng.randint(0, n_validators, 4)] = 31 * 10 ** 9
    active = np.ones(n_validators, bool)
    active[rng.randint(0, n_validators, 2)] = False
    slashed = np.zeros(n_validators, bool)
    slashed[rng.randint(0, n_validators, 2)] = True
    st.set_validators(eb, active=active, slashed=slashed)
    st.set_current_epoch(max(st.slots) // 8 + 1)
    for _ in range(3):
        k = rng.randint(1, 24)
        st.apply_attestations(
            rng.randint(0, n_validators, k).tolist(),
            rng.randint(0, 4, k).tolist(),
            [roots[rng.randint(0, n_blocks)] for _ in range(k)])
    if seed % 2:
        st.set_proposer_boost(roots[rng.randint(1, n_blocks)])
    if seed % 3 == 0:
        st.mark_equivocators(rng.randint(0, n_validators, 2).tolist())
    return st, roots


@pytest.mark.parametrize("seed", range(12))
def test_randomized_store_parity(seed, spec):
    jst, roots = _random_store(seed)
    pst = CV.proto_store_from_mirror(jst, device="cpu")
    assert pst.device.type == "cpu"
    assert pst.fingerprint() == jst.fingerprint()
    head = jst.get_head()
    assert head == jax_oracle.spec_get_head(jst)
    assert pst.get_head() == head
    assert pst.get_head_host(spec) == head
    rng = np.random.RandomState(1000 + seed)
    for _ in range(3):
        k = rng.randint(1, 30)
        batch = (rng.randint(0, 40, k).tolist(), rng.randint(2, 7, k).tolist(),
                 [roots[rng.randint(0, len(roots))] for _ in range(k)])
        assert pst.apply_attestations(*batch) == jst.apply_attestations(*batch)
    assert (pst.node_weights_host() == jst.node_weights_host()).all()
    assert (pst.node_weights_device() == pst.node_weights_host()).all()
    assert pst.get_head() == jst.get_head()
    assert pst.fingerprint() == jst.fingerprint()


def _root(tag: int) -> bytes:
    return bytes([tag]) + b"\x07" * 31


def _pair(n_validators=16, anchor=None, **kw):
    """The same empty store in both packages (minimal preset)."""
    kw.setdefault("slots_per_epoch", 8)
    kw.setdefault("preset", "minimal")
    out = []
    for make in (JaxStore, lambda *a, **k: ProtoArrayStore(*a, device="cpu",
                                                           **k)):
        st = make(anchor or _root(1), 0, **kw)
        if n_validators:
            st.set_validators(np.full(n_validators, GWEI_32, dtype=np.int64))
        out.append(st)
    return out


def _both(stores, op, *args):
    """Run one call on both stores; their answers must be equal."""
    got = [getattr(st, op)(*args) for st in stores]
    if isinstance(got[0], np.ndarray):
        assert (got[0] == got[1]).all(), op
    else:
        assert got[0] == got[1], (op, got)
    return got[1]


def _head(stores, spec, want=None):
    head = _both(stores, "get_head")
    assert stores[1].get_head_host(spec) == head
    if want is not None:
        assert head == want
    assert stores[0].fingerprint() == stores[1].fingerprint()
    return head


def test_scenario_tie_break_lexicographic(spec):
    sts = _pair()
    a, b = _root(0x0A), _root(0x0B)
    _both(sts, "add_block", a, _root(1), 1, 0, 0)
    _both(sts, "add_block", b, _root(1), 1, 0, 0)
    _both(sts, "set_current_epoch", 1)
    _head(sts, spec, max(a, b))
    _both(sts, "apply_attestations", [0], [1], [min(a, b)])
    _head(sts, spec, min(a, b))


def test_scenario_ex_ante_boost_and_expiry(spec):
    sts = _pair(n_validators=64)
    withheld, timely = _root(0x0B), _root(0x0C)
    _both(sts, "add_block", withheld, _root(1), 1, 0, 0)
    _both(sts, "add_block", timely, _root(1), 2, 0, 0)
    _both(sts, "set_current_epoch", 1)
    _both(sts, "apply_attestations", [0], [0], [withheld])
    _both(sts, "set_proposer_boost", timely)
    assert _both(sts, "proposer_score") > 0
    _head(sts, spec, timely)
    _both(sts, "set_proposer_boost", None)
    _head(sts, spec, withheld)


def test_scenario_stale_voting_source(spec):
    sts = _pair(n_validators=0, justified_epoch=5)
    _both(sts, "set_current_epoch", 9)
    good, stale = _root(0x21), _root(0xFE)
    _both(sts, "add_block", good, _root(1), 41, 5, 5)
    _both(sts, "add_block", stale, _root(1), 42, 2, 2)
    _both(sts, "set_checkpoints", 5, _root(1), 0, _root(1))
    _both(sts, "set_validators", np.full(8, GWEI_32, dtype=np.int64))
    _both(sts, "apply_attestations", [0, 1, 2], [8, 8, 8], [stale] * 3)
    _head(sts, spec, good)


def test_scenario_finalized_descent(spec):
    sts = _pair(n_validators=0, justified_epoch=1)
    fin, other, inside = _root(0x0F), _root(0x0E), _root(0x1F)
    _both(sts, "add_block", fin, _root(1), 8, 1, 1)
    _both(sts, "add_block", other, _root(1), 9, 1, 1)
    _both(sts, "add_block", inside, fin, 10, 1, 1)
    _both(sts, "set_checkpoints", 1, _root(1), 1, fin)
    _both(sts, "set_current_epoch", 2)
    _both(sts, "set_validators", np.full(8, GWEI_32, dtype=np.int64))
    _both(sts, "apply_attestations", [0, 1, 2, 3], [1] * 4, [other] * 4)
    _head(sts, spec, inside)


def test_scenario_equivocators_frozen(spec):
    sts = _pair(n_validators=8)
    a, b = _root(0x0A), _root(0x0B)
    _both(sts, "add_block", a, _root(1), 1, 0, 0)
    _both(sts, "add_block", b, _root(1), 2, 0, 0)
    _both(sts, "set_current_epoch", 1)
    _both(sts, "apply_attestations", [0, 1], [1, 1], [min(a, b)] * 2)
    _head(sts, spec, min(a, b))
    _both(sts, "mark_equivocators", [0, 1])
    _head(sts, spec, max(a, b))
    assert _both(sts, "apply_attestations", [0], [3], [min(a, b)]) == 0
    _head(sts, spec, max(a, b))


def test_scenario_degraded_host_spell(spec):
    sts = _pair(n_validators=16)
    a, b = _root(0x0A), _root(0x0B)
    _both(sts, "add_block", a, _root(1), 1, 0, 0)
    _both(sts, "add_block", b, _root(1), 2, 0, 0)
    _both(sts, "set_current_epoch", 1)
    assert _both(sts, "apply_attestations", [0, 1], [1, 1], [a, a]) == 2
    assert _both(sts, "apply_attestations_host", [2, 3, 4], [1, 1, 1],
                 [b, b, b]) == 3
    _both(sts, "apply_attestations", [5], [1], [b])
    _head(sts, spec, b)
    w = _both(sts, "node_weights_host")
    assert w[sts[1].root_index[a]] == 2 * GWEI_32
    assert w[sts[1].root_index[b]] == 4 * GWEI_32
    assert (sts[1].node_weights_device() == w).all()


def test_scenario_block_rung_regrowth(spec, monkeypatch):
    """Crossing 64 -> 1024 blocks rebuilds the device arrays from the
    mirror (K22's plain version at the new rung) without losing weights."""
    sts = _pair(n_validators=8)
    calls = []
    real_refresh = K.fc_refresh

    def counted(lm_block, balance, nb_pad):
        calls.append(nb_pad)
        return real_refresh(lm_block, balance, nb_pad)

    monkeypatch.setattr("consensus_specs_tpu_torch.forkchoice.store."
                        "fc_refresh", counted)
    prev, roots = _root(1), [_root(1)]
    for i in range(70):
        r = bytes([2 + (i % 250)]) + i.to_bytes(2, "big") + b"\x00" * 29
        _both(sts, "add_block", r, prev, i + 1, 0, 0)
        roots.append(r)
        prev = r
        if i == 10:
            _both(sts, "apply_attestations", [0, 1], [1, 1], [r, r])
    _both(sts, "set_current_epoch", max(sts[1].slots) // 8 + 1)
    _head(sts, spec, roots[-1])
    assert calls == [64, 1024]
    w = _both(sts, "node_weights_host")
    assert w[sts[1].root_index[roots[11]]] == 2 * GWEI_32
    assert (sts[1].node_weights_device() == w).all()


def test_scenario_idempotent_under_a_repeated_batch(spec):
    sts = _pair(n_validators=8)
    a = _root(0x0A)
    _both(sts, "add_block", a, _root(1), 1, 0, 0)
    _both(sts, "set_current_epoch", 1)
    assert _both(sts, "apply_attestations", [0, 1], [1, 1], [a, a]) == 2
    w = _both(sts, "node_weights_host")
    assert _both(sts, "apply_attestations", [0, 1], [1, 1], [a, a]) == 0
    assert (_both(sts, "node_weights_host") == w).all()
    assert (sts[1].node_weights_device() == w).all()
    _head(sts, spec, a)


def test_batched_fold_equals_the_spec_sequential_rule(spec):
    sts = _pair(n_validators=8)
    a, b = _root(0x0A), _root(0x0B)
    _both(sts, "add_block", a, _root(1), 1, 0, 0)
    _both(sts, "add_block", b, _root(1), 2, 0, 0)
    _both(sts, "set_current_epoch", 1)
    _both(sts, "apply_attestations", [3], [2], [a])
    idx = [0, 0, 1, 1, 3, 5, 5, 3]
    ep = [1, 2, 3, 3, 1, 4, 5, 2]
    roots = [a, b, a, b, b, a, b, b]
    expected = port_oracle.spec_apply_messages(sts[1], spec, idx, ep, roots)
    assert expected == jax_oracle.spec_apply_messages(sts[0], idx, ep, roots)
    _both(sts, "apply_attestations", idx, ep, roots)
    st = sts[1]
    st._sync_pending()
    got = {int(v): (int(st._lm_epoch[v]), st.roots[int(st._lm_block[v])])
           for v in range(8) if st._lm_block[v] >= 0}
    assert got == expected and got[1] == (3, a)


def test_unknown_roots_and_validators_raise():
    st = _pair(n_validators=8)[1]
    st.add_block(_root(0x0A), _root(1), 1, 0, 0)
    with pytest.raises(KeyError):
        st.apply_attestations([0], [1], [_root(0x77)])
    with pytest.raises(KeyError):
        st.apply_attestations([99], [1], [_root(0x0A)])
    with pytest.raises(KeyError):
        st.add_block(_root(8), _root(7), 2, 0, 0)


# --- the synthetic workload, the oracle route, the bridge -------------------


@pytest.mark.parametrize("n_blocks,n_validators,batch",
                         [(256, 16384, 1024), (40, 300, 64)])
def test_synthetic_workload_is_byte_identical(n_blocks, n_validators, batch):
    jst, jroots = jax_synthetic.synthetic_store(n_blocks, n_validators)
    pst, proots = port_synthetic.synthetic_store(n_blocks, n_validators,
                                                 device="cpu")
    assert proots == jroots
    assert pst.fingerprint() == jst.fingerprint()
    pairs = zip(
        itertools.islice(jax_synthetic.attestation_stream(
            jroots, n_validators, batch), 3),
        itertools.islice(port_synthetic.attestation_stream(
            proots, n_validators, batch), 3))
    for jb, pb in pairs:
        assert jb == pb
        assert pst.apply_attestations(*pb) == jst.apply_attestations(*jb)
        assert pst.get_head() == jst.get_head()
    assert (pst.node_weights_device() == jst.node_weights_host()).all()
    assert pst.fingerprint() == jst.fingerprint()


def test_oracle_route_equals_jax_oracle(spec):
    jst, roots = _random_store(4, n_blocks=12, n_validators=24)
    pst = CV.proto_store_from_mirror(jst, device="cpu")
    assert pst.get_head_host(spec) == jax_oracle.spec_get_head(jst)
    _, jstore = jax_oracle.spec_store_for(jst, spec)
    _, pstore = port_oracle.spec_store_for(pst, spec)
    assert spec.get_head(jstore) == spec.get_head(pstore)
    assert dict(jstore.latest_messages) == dict(pstore.latest_messages)
    with pytest.raises(AssertionError, match="SLOTS_PER_EPOCH"):
        port_oracle.spec_get_head(pst, build_spec("phase0", "mainnet"))


def _bridge_scenario(spec, name):
    """A spec Store from tests/phase0/fork_choice/test_device_store.py's
    scenarios: two zero-weight siblings (tie break), or a vote moving the
    head onto a shorter branch."""
    from consensus_specs_tpu.testlib.context import (
        _cached_genesis, default_activation_threshold, default_balances)
    from consensus_specs_tpu.testlib.helpers.attestations import \
        get_valid_attestation
    from consensus_specs_tpu.testlib.helpers.block import (
        build_empty_block, build_empty_block_for_next_slot)
    from consensus_specs_tpu.testlib.helpers.fork_choice import (
        add_block, get_genesis_forkchoice_store_and_block,
        on_tick_and_append_step, tick_and_add_block,
        tick_and_run_on_attestation)
    from consensus_specs_tpu.testlib.helpers.state import \
        state_transition_and_sign_block

    state = _cached_genesis(spec, default_balances,
                            default_activation_threshold).copy()
    store, _ = get_genesis_forkchoice_store_and_block(spec, state)
    steps = []
    on_tick_and_append_step(
        spec, store, state.slot * spec.config.SECONDS_PER_SLOT
        + store.genesis_time, steps)
    if name == "tie_break":
        signed = []
        for graffiti in (None, b"\x42" * 32):
            post = state.copy()
            block = build_empty_block(spec, post, slot=state.slot + 1)
            if graffiti:
                block.body.graffiti = graffiti
            signed.append(state_transition_and_sign_block(spec, post, block))
        on_tick_and_append_step(
            spec, store, store.genesis_time
            + (signed[1].message.slot + 1) * spec.config.SECONDS_PER_SLOT,
            steps)
        for s in signed:
            list(add_block(spec, store, s, steps))
        want = max(spec.hash_tree_root(s.message) for s in signed)
        return store, bytes(want)
    long_state = state.copy()
    for _ in range(2):
        block = build_empty_block_for_next_slot(spec, long_state)
        s = state_transition_and_sign_block(spec, long_state, block)
        list(tick_and_add_block(spec, store, s, steps))
    short_state = state.copy()
    short = build_empty_block_for_next_slot(spec, short_state)
    short.body.graffiti = b"\x42" * 32
    s = state_transition_and_sign_block(spec, short_state, short)
    list(tick_and_add_block(spec, store, s, steps))
    att = get_valid_attestation(spec, short_state, short.slot, signed=True)
    list(tick_and_run_on_attestation(spec, store, att, steps))
    return store, bytes(spec.hash_tree_root(short))


@pytest.mark.parametrize("name", ["tie_break", "vote_moves_head"])
def test_bridge_equals_jax_device_head(spec, name):
    store, want = _bridge_scenario(spec, name)
    got = port_bridge.device_head(spec, store, device="cpu")
    assert got == jax_bridge.device_head(spec, store) == want
    assert got == bytes(spec.get_head(store))
    proto = port_bridge.proto_from_spec_store(spec, store, device="cpu")
    jproto = jax_bridge.proto_from_spec_store(spec, store)
    assert proto.fingerprint() == jproto.fingerprint()
