"""A run's result line has the contract's keys, in its order (the numbers
compared last), and the entry point refuses to run without the card."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from h100bench import harness, run
from h100bench.tests import tinycell

KEYS = ["correct", "attempted", "failed", "metrics", "device", "check"]


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_keys(trace):
    name = "base512.train_s1"
    r, readings = tinycell.run(name, seed=21, trace=trace)
    out = json.loads(json.dumps(run.result(r, readings, 1)))
    want = KEYS[:5] + (["breakdown"] if trace else []) + KEYS[5:]
    assert list(out) == want
    assert set(out["device"]) == {"platform", "count", "memory_peak_bytes"} \
        | ({"busy_s", "window_s"} if trace else set())
    cell = harness.find_cell(name)
    listed = {m["name"] for m in (cell.per_layer if trace
                                  else cell.end_to_end)}
    assert set(out["metrics"]) <= listed
    if not trace:
        assert set(out["metrics"]) == listed
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert set(out["check"]) == set(cell.limits)
    assert out["correct"] is True
    if trace:
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


def test_exits_without_a_card_and_prints_no_result():
    p = subprocess.run(
        [sys.executable, "h100bench/run.py", "--workload",
         "base512.train_s1", "--seed", "3000000000", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True,
        cwd=harness.ROOT, timeout=300,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode != 0
    assert p.stdout.strip() == ""
