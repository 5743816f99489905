"""A traced window's work by the program's own parts: the ``havatar.*``
ranges that ``havatar_tpu_torch/utils/profiling.py:span`` opens while a
profiler runs, read from the same raw events as ``trace.reduce`` and apart
from it (``trace.Trace`` and every reader of it stay as they are).

- ``device_s``: a kernel, copy or fill belongs to every part open, on any
  thread, at the start of the runtime call that launched it (the same
  Kineto correlation id). A part holds its nested parts' time, and the
  autograd thread's launches in a backward go to ``backward``, open on the
  main thread.
- ``idle_s``: each hole in the union of device intervals goes to the
  innermost part open at its start (the rule ``trace.reduce`` uses for the
  ``bench.*`` ranges).
- ``launches``, ``syncs``: kernel-launch and synchronising runtime calls
  (``LAUNCHES``, ``SYNCS``) made while a part is open.

Work in a step call (a ``bench.*`` range open) under no part goes to
``UNNAMED``; ``TOTAL`` holds all the work in step calls, so the parts add
up to the steps. ``linked_share`` is the share of device time whose launch
call was found; under ``LINKED`` the per-unit readings are None.
"""

from __future__ import annotations

import bisect
import re
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from h100bench.trace import PREFIX, _is_device, _union

PART = "havatar."          # the program's own ranges
UNNAMED = "unnamed"        # in a step call, under no ``havatar.*`` range
TOTAL = "total"            # in a step call (any ``bench.*`` range open)
LINKED = 0.99              # least linked share at which parts are read
# CUDA runtime and driver calls as the profiler records them (host side)
RUNTIME = re.compile(r"cu(da)?[A-Z]")
# name prefixes: cudaLaunchKernel(ExC) for PyTorch's and cuDNN's kernels,
# cuLaunchKernel(Ex) for cuBLAS's and the port's own
LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel")
SYNCS = frozenset({"cudaStreamSynchronize", "cudaDeviceSynchronize",
                   "cudaEventSynchronize", "cudaMemcpy"})
KEYS = ("device_s", "idle_s", "launches", "syncs")


@dataclass
class Parts:
    """What one traced window holds by part."""
    units: int                            # calls or steps in the window
    # {part: {"device_s", "idle_s", "launches", "syncs"}}
    parts: Dict[str, Dict[str, float]] = field(default_factory=dict)
    linked_share: Optional[float] = None  # device time that found its launch

    def per_unit(self, part: str, key: str) -> Optional[float]:
        """``parts[part][key]`` a call or step; None where the part did
        not run or under ``LINKED`` of the device time found its launch."""
        p = self.parts.get(part)
        if (p is None or not self.units or self.linked_share is None
                or self.linked_share < LINKED):
            return None
        return p[key] / self.units


class _Ranges:
    """Host ranges of one name, merged (a name may be open on two threads
    at once): is ``t`` inside one of them?"""

    def __init__(self, spans: List[Tuple[int, int]]):
        merged = _union(spans)
        self.starts = [a for a, _ in merged]
        self.ends = [b for _, b in merged]

    def __contains__(self, t: int) -> bool:
        k = bisect.bisect_right(self.starts, t) - 1
        return k >= 0 and t < self.ends[k]


def _is_device_op(evt) -> bool:
    """A kernel, copy or fill on the device: not a host range's device-side
    copy (marked or named as one), nor an empty interval."""
    if not _is_device(evt):
        return False
    user = getattr(evt, "is_user_annotation", lambda: False)()
    return not (user or evt.name().startswith((PREFIX, PART, "ProfilerStep"))
                or evt.end_ns() <= evt.start_ns())


def reduce_parts(prof, units: int) -> Parts:
    """The profiler's raw events -> ``Parts``."""
    ranges: Dict[str, List[Tuple[int, int]]] = defaultdict(list)
    spans: List[Tuple[int, int, str]] = []
    host: List[Tuple[int, int]] = []      # ``bench.*`` ranges: step calls
    calls: List[Tuple[int, str]] = []     # runtime calls: (start, name)
    launched: Dict[int, int] = {}         # correlation id -> call's start
    dev = []
    for evt in prof.profiler.kineto_results.events():
        name = evt.name()
        a, b = evt.start_ns(), evt.end_ns()
        if _is_device(evt):
            if _is_device_op(evt):
                dev.append((a, b, evt.correlation_id()))
        elif name.startswith(PART):
            ranges[name[len(PART):]].append((a, b))
            spans.append((a, b, name[len(PART):]))
        elif name.startswith(PREFIX):
            host.append((a, b))
        elif RUNTIME.match(name):
            calls.append((a, name))
            launched.setdefault(evt.correlation_id(), a)
    if not ranges and not host:
        return Parts(units)
    busy = _union([(a, b) for a, b, _ in dev])
    inside = {n: _Ranges(r) for n, r in ranges.items()}
    step = _Ranges(host)
    parts = {n: dict.fromkeys(KEYS, 0.0)
             for n in list(inside) + [UNNAMED, TOTAL]}

    def add(t: int, key: str, value: float) -> None:
        open_ = [n for n, r in inside.items() if t in r]
        for n in open_:
            parts[n][key] += value
        if t in step:
            if not open_:
                parts[UNNAMED][key] += value
            parts[TOTAL][key] += value

    device_s = linked_s = 0.0
    for a, b, corr in dev:
        s = (b - a) * 1e-9
        device_s += s
        t = launched.get(corr)
        if t is not None:
            linked_s += s
            add(t, "device_s", s)
    for t, name in calls:
        if name.startswith(LAUNCHES):
            add(t, "launches", 1)
        elif name in SYNCS:
            add(t, "syncs", 1)
    spans.sort()
    starts = [a for a, _, _ in spans]
    for (_, end), (nxt, _) in zip(busy, busy[1:]):
        gap = (nxt - end) * 1e-9
        label = None
        # the latest-starting part that is still open at ``end``
        for k in range(bisect.bisect_right(starts, end) - 1, -1, -1):
            if spans[k][1] > end:
                label = spans[k][2]
                break
        if end in step:
            parts[label or UNNAMED]["idle_s"] += gap
            parts[TOTAL]["idle_s"] += gap
        elif label is not None:
            parts[label]["idle_s"] += gap
    linked = linked_s / device_s if device_s > 0 else None
    return Parts(units, parts, linked)
