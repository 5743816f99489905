"""Median device ms of the G step (CUDA events around the call)."""


def read(run):
    return run.span_ms("g_step")
