"""PyTorch / CUDA port of the `consensus_specs_tpu` device path.

The JAX package stays the reference; this package imports nothing of it
and no JAX.  Its device kernels are hand-written CUDA C++ for Hopper
(`csrc/`, built by `_build` on first use); each has a plain PyTorch
version beside it, which runs for CPU tensors and is what the kernels are
held against.  Entry points run on CUDA unless the caller passes
`device="cpu"`, and raise when asked for CUDA on a machine without a
card.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """`device` as a torch.device; raises for CUDA without a card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "consensus_specs_tpu_torch: CUDA was asked for and no CUDA "
            "device is available (pass device='cpu' for the plain versions)")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


from .params import MAINNET, MINIMAL, EpochParams, params_from_jax  # noqa: E402,F401
from .parallel import (EpochScalars, IncrementalEpochStep,  # noqa: E402,F401
                       MerkleForest, RegistryArrays, ValidatorLeaves,
                       balances_forest, balances_list_root, epoch_sweep,
                       make_epoch_step, registry_forest,
                       validator_records_root, validator_registry_root)
from .ops.sha256 import hash_pairs, sha256_64B_words  # noqa: E402,F401
