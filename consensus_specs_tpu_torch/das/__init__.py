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
    compute       `compute_cells` (K18), `cell_proof_for_column` and
                  `compute_cells_and_kzg_proofs`: all 128 cells and
                  proofs, FK20 on the device (K18, K20, K19).
    recover       `recover_cells_and_kzg_proofs`: the erasure decode
                  with its intermediates on the device (K18, K15), the
                  re-evaluation and the FK20 re-prove.
    sampling      a data-column sampling round: the commitment inclusion
                  proof on the host, the column's cells in one batch.
"""

from .ciphersuite import (  # noqa: F401
    CELLS_PER_EXT_BLOB,
    FIELD_ELEMENTS_PER_CELL,
    CellBatch,
    closed_form_matrix,
    parse_cell_batch,
)
from .compute import (  # noqa: F401
    cell_proof_for_column,
    cells_and_column_proofs,
    compute_cells,
    compute_cells_and_kzg_proofs,
)
from .recover import (  # noqa: F401
    recover_cells_and_kzg_proofs,
    recover_cells_and_kzg_proofs_host,
    recover_coefficients_device,
)
from .sampling import (  # noqa: F401
    DasSample,
    InclusionProof,
    sample_from_matrix,
    sample_from_sidecar,
    verify_inclusion,
    verify_sample,
    verify_sample_host,
)
from .verify import (  # noqa: F401
    das_rung,
    evaluate_cells_at,
    verify_and_isolate,
    verify_cell_proof_batch,
    verify_cell_proof_batch_host,
)
