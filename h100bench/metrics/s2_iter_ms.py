"""The window's seconds over its stage-2 iterations (D + G, R1 where it
falls), in ms."""


def read(run):
    return run.window_s / run.units * 1e3 if run.units else None
