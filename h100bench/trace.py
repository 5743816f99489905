"""The traced window: ``torch.profiler`` over a few calls or steps, reduced
to the device's busy time, kernel time by name and the idle gaps by what the
host was doing.

The host marks its own work with ``span(name)`` ranges (``bench.*``); the
profiler keeps them beside the device's kernels and copies on one clock. A
device interval is a kernel, a copy or a fill; the busy time is the length
of their union, so two streams at once count once. An idle gap is a hole in
that union inside the window, named by the innermost host range open at its
start.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch

PREFIX = "bench."


def span(name: str):
    """A host range ``bench.<name>`` in the trace (about a microsecond
    untraced)."""
    return torch.profiler.record_function(PREFIX + name)


@dataclass
class Trace:
    """What one traced window holds."""
    window_s: float                       # host clock, synchronised ends
    busy_s: float                         # union of device intervals
    kernels: Dict[str, float]             # seconds by device op name
    gaps: Dict[str, float]                # idle seconds by host range
    units: int = 0                        # calls or steps in the window

    def kernel_s(self, *substrings: str) -> float:
        """Seconds of the device ops whose name holds any of
        ``substrings``."""
        return sum(s for n, s in self.kernels.items()
                   if any(k in n for k in substrings))

    def breakdown(self, n: int = 10) -> Dict[str, List]:
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1])[:n]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:n]
        return {"device_ops": [[k, v] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in gaps]}


@dataclass
class Tracer:
    """Profiles from ``start()`` to ``stop(units)``; ``result()`` reduces
    that to a ``Trace`` (after the measured window: it takes seconds)."""
    device: torch.device
    units: int = 0
    _prof: Any = None
    _t0: float = 0.0
    _window_s: float = 0.0

    def start(self) -> None:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        _sync(self.device)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.start()
        self._t0 = time.perf_counter()

    def stop(self, units: int) -> None:
        _sync(self.device)
        self._window_s = time.perf_counter() - self._t0
        self._prof.stop()
        self.units = units

    def result(self) -> Optional[Trace]:
        if self._prof is None:
            return None
        return reduce(self._prof, self._window_s, self.units)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    merged: List[Tuple[int, int]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                merged[-1] = (merged[-1][0], b)
        else:
            merged.append((a, b))
    return merged


def _is_device(evt) -> bool:
    return evt.device_type() != torch.autograd.DeviceType.CPU


def reduce(prof, window_s: float, units: int) -> Trace:
    """The profiler's raw events -> ``Trace``."""
    events = prof.profiler.kineto_results.events()
    device, host = [], []
    kernels: Dict[str, float] = defaultdict(float)
    for evt in events:
        name = evt.name()
        a, b = evt.start_ns(), evt.end_ns()
        if _is_device(evt):
            user = getattr(evt, "is_user_annotation", lambda: False)()
            if user or name.startswith((PREFIX, "ProfilerStep")) or b <= a:
                continue
            device.append((a, b))
            kernels[name] += (b - a) * 1e-9
        elif name.startswith(PREFIX):
            host.append((a, b, name[len(PREFIX):]))
    busy = _union(device)
    gaps: Dict[str, float] = defaultdict(float)
    host.sort()
    starts = [a for a, _, _ in host]
    for (_, end), (nxt, _) in zip(busy, busy[1:]):
        label = "outside_any_range"
        # the latest-starting range that is still open at ``end``
        for k in range(bisect.bisect_right(starts, end) - 1, -1, -1):
            if host[k][1] > end:
                label = host[k][2]
                break
        gaps[label] += (nxt - end) * 1e-9
    busy_s = sum(b - a for a, b in busy) * 1e-9
    return Trace(window_s, busy_s, dict(kernels), dict(gaps), units)
