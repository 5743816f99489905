"""The plain reference: what the program under test computes, in float32
PyTorch, frozen in the benchmark's folder. It imports nothing of the
program (``havatar_tpu_torch``) and nothing of the JAX package."""
