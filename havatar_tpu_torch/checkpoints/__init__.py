"""Weights from the JAX package into the port."""
