"""Data-column sampling rounds (counterpart of the JAX package's
`das/sampling.py`, its synchronous surface): sidecar-shaped checks over
the batched cell verifier.

A PeerDAS node sampling column c receives, per block, one
DataColumnSidecar: the c-th cell of every blob, the blob commitments,
the per-cell proofs, and a Merkle proof that the commitment list is in
the block body.  Verifying it is two halves:

  host   the commitment-inclusion proof (a SHA-256 branch walk,
         `verify_inclusion`, the spec's `is_valid_merkle_branch`);
  device the batched cell checks (`das.verify.verify_cell_proof_batch`:
         all of the column's cells in one RLC pairing equation).

`DasSample` is the payload as plain bytes, `sample_from_sidecar` adapts
a built-spec `DataColumnSidecar`, and `sample_from_matrix` cuts column
samples out of a flat sampling matrix (`ciphersuite.closed_form_matrix`).

The `*_async` forms, the cross-sample group and the telemetry counters
are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from hashlib import sha256

from . import ciphersuite as cs
from . import verify as _verify


@dataclass
class InclusionProof:
    """One SSZ single-branch proof: `leaf` hashes up `branch` at
    subtree position `index` to `root`."""

    leaf: bytes
    branch: list
    index: int
    root: bytes


@dataclass
class DasSample:
    """One sampled data column as plain bytes."""

    column_index: int
    commitments: list           # 48 B per blob (row commitments)
    cells: list                 # 2048 B each, this column's cell per row
    proofs: list                # 48 B each
    inclusion: InclusionProof | None = None


def verify_inclusion(proof: InclusionProof) -> bool:
    """The spec's `is_valid_merkle_branch` (host SHA-256; the depth is
    the branch length)."""
    value = bytes(proof.leaf)
    for i, sibling in enumerate(proof.branch):
        if (int(proof.index) >> i) & 1:
            value = sha256(bytes(sibling) + value).digest()
        else:
            value = sha256(value + bytes(sibling)).digest()
    return value == bytes(proof.root)


def _host_precheck(sample: DasSample) -> bool | None:
    """The device-free front half of every route: False on a structural
    or inclusion reject, None when the cell checks still have to
    decide."""
    if not (len(sample.commitments) == len(sample.cells)
            == len(sample.proofs)) or not sample.cells:
        return False
    if int(sample.column_index) >= cs.CELLS_PER_EXT_BLOB:
        return False
    if sample.inclusion is not None \
            and not verify_inclusion(sample.inclusion):
        return False
    return None


def verify_sample(sample: DasSample, device=None) -> bool:
    """The sampling check of one column: the structure and the host
    inclusion walk, then the column's cells as one batch
    (`verify_cell_proof_batch`, on the device by default; `device` as
    there).  Malformed cell statements raise."""
    early = _host_precheck(sample)
    if early is not None:
        return early
    return _verify.verify_cell_proof_batch(
        sample.commitments, [int(sample.column_index)] * len(sample.cells),
        sample.cells, sample.proofs, device=device)


def verify_sample_host(sample: DasSample) -> bool:
    """The pure-host route: the same verdict as `verify_sample`, through
    the host verifier only."""
    early = _host_precheck(sample)
    if early is not None:
        return early
    return _verify.verify_cell_proof_batch_host(
        sample.commitments, [int(sample.column_index)] * len(sample.cells),
        sample.cells, sample.proofs)


def sample_from_matrix(commitments, cell_indices, cells, proofs,
                       column_index: int) -> DasSample:
    """Cut one column's sample out of a flat sampling matrix (the
    `closed_form_matrix` / `verify_cell_kzg_proof_batch` argument
    shape)."""
    column_index = int(column_index)
    rows = [k for k, c in enumerate(cell_indices)
            if int(c) == column_index]
    return DasSample(
        column_index=column_index,
        commitments=[bytes(commitments[k]) for k in rows],
        cells=[bytes(cells[k]) for k in rows],
        proofs=[bytes(proofs[k]) for k in rows],
    )


def sample_from_sidecar(spec, sidecar) -> DasSample:
    """Adapt a built-spec `DataColumnSidecar` (the commitment list root
    and its inclusion branch against the sidecar's block-body root)."""
    gindex = spec.get_generalized_index(spec.BeaconBlockBody,
                                        "blob_kzg_commitments")
    inclusion = InclusionProof(
        leaf=bytes(spec.hash_tree_root(sidecar.kzg_commitments)),
        branch=[bytes(b) for b in
                sidecar.kzg_commitments_inclusion_proof],
        index=int(spec.get_subtree_index(gindex)),
        root=bytes(sidecar.signed_block_header.message.body_root),
    )
    return DasSample(
        column_index=int(sidecar.index),
        commitments=[bytes(c) for c in sidecar.kzg_commitments],
        cells=[bytes(c) for c in sidecar.column],
        proofs=[bytes(p) for p in sidecar.kzg_proofs],
        inclusion=inclusion,
    )
