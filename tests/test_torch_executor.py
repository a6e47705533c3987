"""Slice 7 of the port, the batched block executor
(`consensus_specs_tpu_torch/executor.py`) against the JAX package's
(`consensus_specs_tpu/executor.py`), on the CPU: the post-state roots of
the same signed blocks must be equal (tolerance zero, they are hashes),
a tampered aggregate must be rejected at the batch settle as JAX rejects
it, and `spec.bls` must be the module it was before every call, also one
that raised.  With BLS on, the port's facade runs its "torch" backend on
the CPU: the eager checks through the plain K12 -> K10 and the deferred
batch through the plain K11 -> K8 -> K9 -> K10.
"""

import pytest
import torch

from consensus_specs_tpu import executor as jax_executor
from consensus_specs_tpu.models.builder import build_spec
from consensus_specs_tpu.ops import bls as jax_bls
from consensus_specs_tpu.testlib.context import (
    _cached_genesis,
    default_activation_threshold,
    default_balances,
)
from consensus_specs_tpu.testlib.helpers.attestations import (
    get_valid_attestation,
)
from consensus_specs_tpu.testlib.helpers.block import (
    build_empty_block_for_next_slot,
    sign_block,
    transition_unsigned_block,
)
from consensus_specs_tpu.testlib.helpers.state import next_slots
from consensus_specs_tpu_torch import executor
from consensus_specs_tpu_torch.ops import bls as port_bls


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the plain pairing stages are many small ops,
    and parallel test workers must not oversubscribe the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def bls_on(monkeypatch):
    """Signatures on in both facades, the port's on the CPU."""
    monkeypatch.setattr(jax_bls, "bls_active", True)
    monkeypatch.setattr(port_bls, "bls_active", True)
    monkeypatch.setattr(port_bls, "_backend_name", "torch")
    monkeypatch.setattr(port_bls, "_device", "cpu")


@pytest.fixture
def bls_off(monkeypatch):
    monkeypatch.setattr(jax_bls, "bls_active", False)
    monkeypatch.setattr(port_bls, "bls_active", False)


def _make_attested_block(spec, state):
    """A block carrying one signed attestation (tests/test_executor.py's
    `_make_attested_block`)."""
    next_slots(spec, state, spec.MIN_ATTESTATION_INCLUSION_DELAY + 1)
    attestation = get_valid_attestation(
        spec, state, slot=state.slot - spec.MIN_ATTESTATION_INCLUSION_DELAY,
        signed=True)
    block = build_empty_block_for_next_slot(spec, state)
    block.body.attestations.append(attestation)
    return block


def _signed_block(spec, state, tamper=False):
    """(pre-state, signed block): the post root computed on an unsigned
    transition; with `tamper`, the attestation's aggregate is replaced by
    a signature of another message after that, and the block re-signed."""
    state = state.copy()
    block = _make_attested_block(spec, state)
    shadow = state.copy()
    transition_unsigned_block(spec, shadow, block)
    block.state_root = spec.hash_tree_root(shadow)
    if tamper:
        block.body.attestations[0].signature = jax_bls.Sign(
            12345, b"\x42" * 32)
    return state, sign_block(spec, state.copy(), block)


def _genesis(spec):
    return _cached_genesis(spec, default_balances,
                           default_activation_threshold)


@pytest.mark.parametrize("fork", ["phase0", "altair"])
def test_bls_off_post_root_equals_jax(fork, bls_off):
    spec = build_spec(fork, "minimal")
    state, signed = _signed_block(spec, _genesis(spec))
    before = spec.bls
    want = jax_executor.state_transition_batched(spec, state.copy(), signed)
    got = executor.state_transition_batched(spec, state.copy(), signed)
    assert spec.hash_tree_root(got) == spec.hash_tree_root(want)
    assert got.slot == signed.message.slot
    assert spec.bls is before is jax_bls


def test_spec_bls_restored_after_a_call_that_raised(bls_off):
    spec = build_spec("phase0", "minimal")
    state, signed = _signed_block(spec, _genesis(spec))
    seen = []
    real = spec.process_block

    def spy(st, block):
        seen.append(spec.bls)
        raise RuntimeError("boom")

    spec.process_block = spy
    try:
        with pytest.raises(RuntimeError, match="boom"):
            executor.state_transition_batched(spec, state.copy(), signed)
    finally:
        spec.process_block = real
    assert seen == [port_bls]
    assert spec.bls is jax_bls
    # a wrong state root raises after the settle: restored too
    signed.message.state_root = b"\x01" * 32
    with pytest.raises(AssertionError):
        executor.state_transition_batched(spec, state.copy(), signed)
    assert spec.bls is jax_bls
    assert port_bls._deferred is None


def test_bls_on_attested_block_equals_jax(bls_on):
    spec = build_spec("phase0", "minimal")
    state, signed = _signed_block(spec, _genesis(spec))
    want = jax_executor.state_transition_batched(spec, state.copy(), signed,
                                                 device=False)
    got = executor.state_transition_batched(spec, state.copy(), signed,
                                            device="cpu")
    assert spec.hash_tree_root(got) == spec.hash_tree_root(want)
    assert spec.bls is jax_bls


def test_bls_on_tampered_aggregate_rejected_at_the_settle(bls_on,
                                                         monkeypatch):
    spec = build_spec("phase0", "minimal")
    state, signed = _signed_block(spec, _genesis(spec), tamper=True)
    with pytest.raises(AssertionError):
        jax_executor.state_transition_batched(
            spec, state.copy(), signed, validate_result=False, device=False)
    settled = []
    real = executor.settle_deferred

    def spy(batch, device=None):
        ok = real(batch, device=device)
        settled.append((len(batch.tasks), ok))
        return ok

    monkeypatch.setattr(executor, "settle_deferred", spy)
    with pytest.raises(AssertionError, match="batched aggregate-signature"):
        executor.state_transition_batched(spec, state.copy(), signed,
                                          validate_result=False,
                                          device="cpu")
    assert settled == [(1, False)]
    assert spec.bls is jax_bls
