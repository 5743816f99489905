"""Cells of ``BENCHMARK.json`` cut to a size the CPU runs in seconds, for
the benchmark's own tests: the configurations ``tiny_hd.json`` and
``tiny_s1.json`` beside this file (the widths of the program's tiny test
configurations), small batches and few calls or steps. The limits stay the
cells' own."""

from __future__ import annotations

import json
import time
from pathlib import Path

import torch

from h100bench import harness
from h100bench.run import measure

HERE = Path(__file__).resolve().parent
CPU = torch.device("cpu")

TRAFFIC = {
    "hd512.train_dg": ("tiny_hd", dict(trace_iterations=2)),
    "base512.train_s1": ("tiny_s1", dict(patch=16, trace_steps=2)),
}


def cell(name: str) -> harness.Cell:
    c = harness.find_cell(name)
    config, traffic = TRAFFIC[name]
    with open(HERE / f"{config}.json") as f:
        c.config = json.load(f)
    c.traffic = {**c.traffic, **traffic}
    return c


def run(name: str, seed: int = 11, trace: bool = False,
        seconds: float = 0.2):
    """(Run, readings) of one tiny run on the CPU."""
    torch.set_num_threads(4)
    return measure(cell(name), seed, seconds, trace, CPU, time.perf_counter())
