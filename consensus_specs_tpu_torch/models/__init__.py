"""Spec modules of the port (counterpart of `consensus_specs_tpu.models`)."""
