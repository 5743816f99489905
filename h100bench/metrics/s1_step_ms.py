"""The window's seconds over its stage-1 steps, in ms."""


def read(run):
    return run.window_s / run.units * 1e3 if run.units else None
