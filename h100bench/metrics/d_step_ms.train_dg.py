"""Median device ms of the D step (CUDA events around the call)."""


def read(run):
    return run.span_ms("d_step")
