"""Fork choice on the card (counterpart of `consensus_specs_tpu.forkchoice`):
LMD-GHOST over a proto-array store, its latest-message folding and head
selection as flat-array segment reductions.

    kernels    the `fc_rung` ladders, K21 (apply), K22 (refresh) and K23
               (head) with their plain versions
    store      `ProtoArrayStore`: device tensors and a bit-equal host
               mirror, synchronous
    oracle     the phase0 spec's `get_head` over a Store synthesized from
               the mirror (the spec is an argument)
    synthetic  the seeded tree and attestation stream of the fork-choice
               workload
    bridge     spec Store -> proto store
"""

from .kernels import (
    FC_BATCH_STEPS,
    FC_BLOCK_STEPS,
    FC_VALIDATOR_STEPS,
    fc_rung,
)
from .store import ProtoArrayStore

__all__ = [
    "FC_BATCH_STEPS",
    "FC_BLOCK_STEPS",
    "FC_VALIDATOR_STEPS",
    "ProtoArrayStore",
    "fc_rung",
]
