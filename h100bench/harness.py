"""What every cell shares: the record of a run, the CUDA-event spans, the
files a cell is made of (found by name), and the result line.

A cell ``<config>.<traffic>`` of ``BENCHMARK.json`` is made of
``configs/<config>.json`` (the configuration as it is run),
``traffic/<traffic>.json`` (the mix's parameters; its ``kind`` names the
driver in ``drivers/<kind>.py``), ``limits/<cell>.json`` (the limit of each
number that decides ``correct``) and the metrics that ``BENCHMARK.json``
lists for the cell, each read by ``metrics/<metric>.py`` or, where a metric
of the same name before its first dot is read alike in every cell, by
``metrics/<that name>.py``.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import statistics
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import torch

T0 = time.perf_counter()
HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names that no run may hold, compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "havatar_tpu")


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    """One entry of ``workloads`` with its files and metrics."""
    name: str
    config: Dict
    traffic: Dict
    limits: Dict[str, float]
    end_to_end: List[Dict]
    per_layer: List[Dict]
    chips: int = 1

    def driver(self):
        return importlib.import_module(
            f"h100bench.drivers.{self.traffic['kind']}")


def _reports(metric: Dict, cell: str, reported: List[str]) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") in reported if "moves" in metric else True


def find_cell(name: str, bench: Optional[Dict] = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` (or of ``bench``)."""
    bench = bench if bench is not None else load_json(ROOT / "BENCHMARK.json")
    spec = next((w for w in bench["workloads"] if w["name"] == name), None)
    if spec is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    e2e = [m for m in bench["end_to_end"] if _reports(m, name, [])]
    names = [m["name"] for m in e2e]
    per_layer = [m for m in bench["per_layer"]
                 if _reports(m, name, names)]
    limits_path = HERE / "limits" / f"{name}.json"
    limits = load_json(limits_path) if limits_path.exists() else {}
    return Cell(name, load_json(HERE / "configs" / f"{spec['config']}.json"),
                load_json(HERE / "traffic" / f"{spec['traffic']}.json"),
                limits, e2e, per_layer, spec.get("chips", 1))


def reader(metric: str) -> Callable[["Run"], Optional[float]]:
    """``metrics/<metric>.py``'s ``read``; where that file is missing, that
    of ``metrics/<metric's name before its first dot>.py`` (one reader for
    ``device_idle.<cell>`` of every cell)."""
    path = HERE / "metrics" / f"{metric}.py"
    if not path.exists():
        path = HERE / "metrics" / f"{metric.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(
        f"h100bench.metrics.{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Spans:
    """Device time of named pieces of work, from CUDA events recorded on
    the current stream around them (host clock on the CPU, where a test
    runs). Read after the window has synchronised."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.open: Dict[str, Any] = {}
        self.done: Dict[str, List] = {}

    def _mark(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def start(self, name: str) -> None:
        self.open[name] = self._mark()

    def stop(self, name: str) -> None:
        self.done.setdefault(name, []).append((self.open.pop(name),
                                               self._mark()))

    def ms(self, name: str) -> List[float]:
        pairs = self.done.get(name, [])
        if self.cuda:
            return [a.elapsed_time(b) for a, b in pairs]
        return [(b - a) * 1e3 for a, b in pairs]

    def hook(self, first: torch.nn.Module, last: torch.nn.Module,
             name: str) -> List:
        """A span from ``first``'s forward start to ``last``'s forward
        end; returns the hook handles."""
        return [first.register_forward_pre_hook(
                    lambda *a: self.start(name)),
                last.register_forward_hook(lambda *a: self.stop(name))]


@dataclass
class Run:
    """What one run measured; the metric readers take it."""
    cell: Cell
    seed: int
    device: torch.device
    trace: bool
    setup_s: float = 0.0
    window_s: float = 0.0
    units: int = 0                        # calls or steps in the window
    spans: Optional[Spans] = None
    traced: Any = None                    # trace.Trace of the sub-window
    extra: Dict[str, Any] = field(default_factory=dict)

    def span_ms(self, name: str) -> Optional[float]:
        xs = self.spans.ms(name) if self.spans else []
        return statistics.median(xs) if xs else None

    def share(self, least_s: float, *kernels: str) -> Optional[float]:
        """A kernel family's roofline share in %: ``least_s`` (the least
        time of the traced sub-window's work) over the family's device
        time there; None when the family did not run."""
        if self.traced is None:
            return None
        t = self.traced.kernel_s(*kernels)
        return 100.0 * least_s / t if t > 0 else None


def log(msg: str) -> None:
    """A progress line on standard error, with the seconds since the run
    began (set-up's parts)."""
    print(f"h100bench: {time.perf_counter() - T0:8.2f} s  {msg}",
          file=sys.stderr, flush=True)


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))

