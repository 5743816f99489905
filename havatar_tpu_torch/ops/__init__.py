"""Numerics of the port: rays, sampling, compositing, resampling and the
CUDA march kernels' wrappers (see havatar_tpu/ops)."""
