"""Fulu spec modules of the port: PeerDAS's KZG sampling library
(`polynomial_commitments_sampling`)."""
