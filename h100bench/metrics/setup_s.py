"""Seconds from the start of the process to the window: imports, models
and weights on the device, the kernels' build or load, warm-up."""


def read(run):
    return run.setup_s
