"""PeerDAS on the card (counterpart of `consensus_specs_tpu.das`): cell
statement parsing, batched cell-proof verification and cell extension.

Modules:

    ciphersuite   host-side parse/validate of cell statements against the
                  fulu spec (coset shifts, cell unpacking, the
                  Fiat-Shamir challenge), the coset tables and the
                  closed-form sampling matrices.
    verify        `verify_cell_proof_batch`: the batched RLC check, host
                  route and device route (K17, K13/K14, K12 -> K10);
                  `verify_and_isolate`; `evaluate_cells_at` (K16).
    compute       `compute_cells`: one inverse and one forward field FFT
                  (K18).

The sampling round, recovery and the FK20 proofs are not ported yet.
"""

from .ciphersuite import (  # noqa: F401
    CELLS_PER_EXT_BLOB,
    FIELD_ELEMENTS_PER_CELL,
    CellBatch,
    closed_form_matrix,
    parse_cell_batch,
)
from .compute import compute_cells  # noqa: F401
from .verify import (  # noqa: F401
    das_rung,
    evaluate_cells_at,
    verify_and_isolate,
    verify_cell_proof_batch,
    verify_cell_proof_batch_host,
)
