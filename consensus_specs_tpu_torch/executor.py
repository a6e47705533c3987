"""Batched block executor (counterpart of `consensus_specs_tpu.executor`).

The executable spec's ``state_transition`` checks every aggregate
signature inline.  This executor runs the spec with the port's BLS facade
(`ops.bls`) bound as ``spec.bls``: the FastAggregateVerify statements of
the block body are recorded, their inputs validated eagerly, and settled
afterwards in one random-linear-combination batch on the card
(``DeferredBatch.verify``: K11 -> K8 -> K9 -> K10).  The individual
signatures (proposer, RANDAO, exits, deposits) stay eager, on the card
through the facade (K12 -> K10), because a deposit with a bad signature
is a valid block and its check must resolve before it steers control
flow.  Semantics match the inline path for every valid block; an invalid
aggregate fails the batch settle with an AssertionError, where the spec
would fail too.

A built spec late-binds its globals through its namespace, and built
specs are shared (the builder caches them), so the facade is bound for
the call only and the previous ``spec.bls`` is restored in a ``finally``,
also when the call raises.  The facade's own ``bls_active`` switch
applies while it is bound.

Left out for the port's service slice: the JAX executor's settle breaker
(``arm_breakers``, the oracle fallback, the degraded counters) and its
telemetry spans.
"""

from __future__ import annotations

from .ops import bls


def settle_deferred(batch, device=None) -> bool:
    """Settle a `DeferredBatch`: ``batch.verify(device=device)`` (None
    follows the facade's backend, True is CUDA, False the host oracle, a
    torch device or its name runs the RLC batch there)."""
    return batch.verify(device=device)


def state_transition_batched(spec, state, signed_block,
                             validate_result: bool = True, device=None):
    """``spec.state_transition`` with the aggregate pairings settled in one
    batch.  Raises AssertionError where the spec would, and at the end if
    the batch fails; on failure the state is partly advanced, so run on a
    copy, as on_block does."""
    block = signed_block.message
    previous = spec.bls
    spec.bls = bls
    try:
        spec.process_slots(state, block.slot)
        if validate_result:
            assert spec.verify_block_signature(state, signed_block)
        with bls.deferred_batch_verification() as batch:
            spec.process_block(state, block)
        assert settle_deferred(batch, device=device), \
            "batched aggregate-signature verification failed"
        if validate_result:
            assert block.state_root == spec.hash_tree_root(state)
    finally:
        spec.bls = previous
    return state
