"""Weights into the port: from JAX variables and from .pt checkpoints."""
