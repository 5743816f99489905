"""Every cell of BENCHMARK.json resolves to its files, and the file keeps
the contract's shape."""

from __future__ import annotations

import json
import re

import pytest

from h100bench import harness

BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["h100bench"]
    assert all(not w.startswith("/") and ".." not in w
               for w in BENCH["command"])
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves(name):
    cell = harness.find_cell(name)
    assert cell.chips == 1
    assert hasattr(cell.driver(), "build")
    assert cell.limits and all(v > 0 for v in cell.limits.values())
    reported = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert callable(harness.reader(m["name"]))
    for m in cell.per_layer:
        assert m["moves"] in reported


def test_names_units_and_bounds():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics]
    assert len(names) == len(set(names))
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25
               for m in BENCH["end_to_end"])


def test_configs_used_and_files_under_paths():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("h100bench/")
        with open(harness.ROOT / c["file"]) as f:
            cfg = json.load(f)
        assert cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"] == []
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in BENCH["workloads"]:
        assert len(w["why"]) <= 200 and w["name"] == \
            f"{w['config']}.{w['traffic']}"
