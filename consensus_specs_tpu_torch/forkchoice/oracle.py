"""The spec-oracle route: phase0 ``get_head`` over a synthesized Store
(counterpart of `consensus_specs_tpu.forkchoice.oracle`).

The store's host mirror carries exactly the facts the spec's fork choice
reads: blocks (slot, parent, root), the latest-message table, the
justified-checkpoint validator set, the checkpoints and the boost.
``spec_store_for`` lifts the mirror into a genuine ``spec.Store`` and
``spec_get_head`` runs the spec's own ``get_head`` on it, so every
weight, viability filter and tie-break comes from the spec's code.

One difference from the JAX module: that one builds its spec with the
JAX package's builder.  The port imports nothing of the JAX package, so
here ``spec`` is a required argument: a built phase0 spec namespace of
the store's preset (the tests pass
`consensus_specs_tpu.models.builder.build_spec("phase0", preset)`).  This
module imports no spec and no JAX.

Synthesis notes:

- ``store.blocks`` is keyed by the root bytes; the spec's walk follows
  ``parent_root`` through the dict and never re-hashes a block, so
  ``spec.BeaconBlock(slot, parent_root)`` rows suffice.
- ``block_states`` entries serve only ``get_voting_source`` (it reads
  ``current_justified_checkpoint``), so each is a one-field shim; the
  justified checkpoint state is a real ``spec.BeaconState`` (``get_weight``
  and ``get_proposer_score`` read balances and the active set off it).
- ``spec_apply_messages`` runs the spec's ``update_latest_messages``
  message by message, the pin for the batched fold's rule.
"""

from __future__ import annotations

import hashlib
from types import SimpleNamespace


def _check_spec(spec, proto) -> None:
    assert int(spec.SLOTS_PER_EPOCH) == proto.slots_per_epoch, \
        (f"the spec has SLOTS_PER_EPOCH={int(spec.SLOTS_PER_EPOCH)}, the "
         f"store was built with {proto.slots_per_epoch}")
    assert int(spec.config.PROPOSER_SCORE_BOOST) == proto.proposer_boost_pct
    assert int(spec.EFFECTIVE_BALANCE_INCREMENT) \
        == proto.effective_balance_increment


def _checkpoint_state(spec, proto):
    """A BeaconState at the justified boundary whose registry reproduces
    the store's (balance, active, slashed) rows."""
    far = spec.FAR_FUTURE_EPOCH
    validators = [
        spec.Validator(
            effective_balance=int(eb),
            slashed=bool(sl),
            activation_eligibility_epoch=0,
            activation_epoch=0 if act else far,
            exit_epoch=far,
            withdrawable_epoch=far,
        )
        for eb, act, sl in zip(proto._eb, proto._active, proto._slashed)]
    return spec.BeaconState(
        slot=spec.compute_start_slot_at_epoch(
            spec.Epoch(proto.justified_epoch)),
        validators=validators,
    )


def spec_store_for(proto, spec):
    """(spec, Store): the spec Store synthesized from the store's host
    mirror (pending device batches fold in first)."""
    proto._sync_pending()
    _check_spec(spec, proto)
    seconds = int(spec.config.SECONDS_PER_SLOT)
    justified = spec.Checkpoint(
        epoch=spec.Epoch(proto.justified_epoch),
        root=spec.Root(proto.justified_root))
    finalized = spec.Checkpoint(
        epoch=spec.Epoch(proto.finalized_epoch),
        root=spec.Root(proto.finalized_root))
    blocks = {}
    block_states = {}
    unrealized = {}
    # the anchor's parent points outside the store (a zero parent would
    # alias an all-zero anchor root and make the anchor its own child)
    outside = bytes(32)
    while outside in proto.root_index:
        outside = hashlib.sha256(outside + proto.roots[0]).digest()
    for i, root in enumerate(proto.roots):
        parent = proto.roots[proto.parent[i]] if proto.parent[i] >= 0 \
            else outside
        blocks[spec.Root(root)] = spec.BeaconBlock(
            slot=spec.Slot(proto.slots[i]), parent_root=spec.Root(parent))
        block_states[spec.Root(root)] = SimpleNamespace(
            current_justified_checkpoint=spec.Checkpoint(
                epoch=spec.Epoch(proto.je[i])))
        unrealized[spec.Root(root)] = spec.Checkpoint(
            epoch=spec.Epoch(proto.uje[i]))
    store = spec.Store(
        time=spec.uint64(proto.current_epoch * proto.slots_per_epoch
                         * seconds),
        genesis_time=spec.uint64(0),
        justified_checkpoint=justified,
        finalized_checkpoint=finalized,
        unrealized_justified_checkpoint=justified,
        unrealized_finalized_checkpoint=finalized,
        proposer_boost_root=spec.Root(proto.proposer_boost_root
                                      or b"\x00" * 32),
        equivocating_indices={
            spec.ValidatorIndex(int(v))
            for v in range(proto.n_validators) if proto._equiv[v]},
        blocks=blocks,
        block_states=block_states,
        checkpoint_states={justified: _checkpoint_state(spec, proto)},
        unrealized_justifications=unrealized,
    )
    store.latest_messages = {
        spec.ValidatorIndex(int(v)): spec.LatestMessage(
            epoch=spec.Epoch(int(proto._lm_epoch[v])),
            root=spec.Root(proto.roots[int(proto._lm_block[v])]))
        for v in range(proto.n_validators) if proto._lm_block[v] >= 0}
    return spec, store


def spec_get_head(proto, spec) -> bytes:
    """The spec's ``get_head`` over the synthesized store."""
    spec, store = spec_store_for(proto, spec)
    return bytes(spec.get_head(store))


def spec_apply_messages(proto, spec, validator_indices, target_epochs,
                        block_roots):
    """The spec's ``update_latest_messages`` run message by message over
    a synthesized store; returns {validator: (epoch, root)}."""
    spec, store = spec_store_for(proto, spec)
    for v, e, r in zip(validator_indices, target_epochs, block_roots):
        att = SimpleNamespace(data=SimpleNamespace(
            target=spec.Checkpoint(epoch=spec.Epoch(int(e))),
            beacon_block_root=spec.Root(bytes(r))))
        spec.update_latest_messages(store, [spec.ValidatorIndex(int(v))],
                                    att)
    return {int(v): (int(m.epoch), bytes(m.root))
            for v, m in store.latest_messages.items()}
