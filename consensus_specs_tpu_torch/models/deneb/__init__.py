"""Deneb spec modules of the port: the KZG library
(`polynomial_commitments`)."""
