"""The benchmark of havatar_tpu_torch on NVIDIA H100s: ``run.py`` runs one
cell of ``BENCHMARK.json`` once; ``calibrate.py`` takes the readings its
limits are set from. Nothing here imports JAX or the JAX package, and the
plain reference (``reference/``) imports nothing of the program."""
