"""PyTorch/CUDA port of havatar_tpu for NVIDIA Hopper (H100).

The JAX package ``havatar_tpu`` is the reference; this package computes the
same functions with PyTorch and hand-written CUDA kernels. It never imports
JAX, flax or ``havatar_tpu``: what it needs from there is copied here.

Layout mirrors ``havatar_tpu``: ``ops/`` (numerics and the march kernels'
wrappers), ``models/`` (nn.Modules), ``infer/`` (the reenactment frame),
``checkpoints/`` (weights from the JAX package) and ``csrc/`` (CUDA sources).
Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""

from havatar_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
