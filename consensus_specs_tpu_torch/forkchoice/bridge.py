"""Spec Store -> proto-array store (counterpart of
`consensus_specs_tpu.forkchoice.bridge`).

The fork-choice suites drive the executable spec's event-sourced
``Store`` (on_tick, on_block, on_attestation with real blocks and state
transitions).  ``proto_from_spec_store`` projects that Store into a
``ProtoArrayStore``: blocks in parent-before-child order, the
justified-checkpoint validator set, the latest-message table, the
checkpoints, the clock and the proposer boost; ``device_head`` answers
``get_head`` for it through K23.  Both take the built spec as an
argument.
"""

from __future__ import annotations

import numpy as np

from .store import ProtoArrayStore


def proto_from_spec_store(spec, store, device="cuda"):
    """Project a spec Store into a ProtoArrayStore on ``device`` (one
    shot: a fresh projection cannot drift from the Store)."""
    ordered = sorted(store.blocks.items(),
                     key=lambda kv: (int(kv[1].slot), bytes(kv[0])))
    anchors = [(root, blk) for root, blk in ordered
               if spec.Root(blk.parent_root) not in store.blocks]
    assert len(anchors) == 1, "expected exactly one anchor block"
    anchor_root, anchor_block = anchors[0]

    def _uje(root):
        return int(store.unrealized_justifications[root].epoch)

    def _je(root):
        return int(store.block_states[root]
                   .current_justified_checkpoint.epoch)

    proto = ProtoArrayStore(
        bytes(anchor_root), int(anchor_block.slot),
        justified_epoch=_je(anchor_root),
        slots_per_epoch=int(spec.SLOTS_PER_EPOCH),
        proposer_boost_pct=int(spec.config.PROPOSER_SCORE_BOOST),
        effective_balance_increment=int(spec.EFFECTIVE_BALANCE_INCREMENT),
        preset=str(spec.config.PRESET_BASE),
        device=device,
    )
    proto.uje[0] = _uje(anchor_root)
    for root, blk in ordered:
        if root == anchor_root:
            continue
        proto.add_block(bytes(root), bytes(blk.parent_root), int(blk.slot),
                        _je(root), _uje(root))

    # the justified checkpoint state is the weight source; synthesize it
    # as store_target_checkpoint_state would when no attestation pinned it
    cp = store.justified_checkpoint
    state = store.checkpoint_states.get(cp)
    if state is None:
        state = store.block_states[cp.root].copy()
        boundary = spec.compute_start_slot_at_epoch(cp.epoch)
        if state.slot < boundary:
            spec.process_slots(state, boundary)
    epoch = spec.get_current_epoch(state)
    n = len(state.validators)
    eb = np.zeros(n, dtype=np.int64)
    active = np.zeros(n, dtype=bool)
    slashed = np.zeros(n, dtype=bool)
    equiv = np.zeros(n, dtype=bool)
    for i, v in enumerate(state.validators):
        eb[i] = int(v.effective_balance)
        active[i] = spec.is_active_validator(v, epoch)
        slashed[i] = bool(v.slashed)
    for i in store.equivocating_indices:
        if int(i) < n:
            equiv[int(i)] = True
    proto.set_validators(eb, active=active, slashed=slashed,
                         equivocating=equiv)

    proto.set_checkpoints(int(cp.epoch), bytes(cp.root),
                          int(store.finalized_checkpoint.epoch),
                          bytes(store.finalized_checkpoint.root))
    proto.set_current_epoch(int(spec.get_current_store_epoch(store)))
    boost = bytes(store.proposer_boost_root)
    proto.set_proposer_boost(boost if any(boost) else None)

    # the latest-message table as one batch (already per-validator latest,
    # so the fold's accept rule passes every row)
    items = sorted(store.latest_messages.items(), key=lambda kv: int(kv[0]))
    if items:
        proto.apply_attestations(
            [int(v) for v, _ in items],
            [int(m.epoch) for _, m in items],
            [bytes(m.root) for _, m in items])
    return proto


def device_head(spec, store, device="cuda") -> bytes:
    """The proto store's head (K23) for a spec Store."""
    return proto_from_spec_store(spec, store, device=device).get_head()
