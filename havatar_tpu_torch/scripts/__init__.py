"""Measurement scripts (counterparts of the JAX package's ``scripts/``)."""
