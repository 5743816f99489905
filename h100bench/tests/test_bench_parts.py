"""``trace_parts.reduce_parts`` puts a hand-made window's work down to the
program's ``havatar.*`` ranges, and the program's ranges and the runtime
calls leave every field of ``trace.reduce``'s ``Trace`` as it was."""

from __future__ import annotations

from types import SimpleNamespace

import pytest
import torch

from h100bench import trace, trace_parts
from h100bench.trace_parts import TOTAL, UNNAMED

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


class Evt:
    """A profiler event as ``reduce`` and ``reduce_parts`` read it."""

    def __init__(self, name, a, b, device=False, corr=0, user=False,
                 thread=1):
        self._name, self._a, self._b = name, a, b
        self._dev, self._corr, self._user = device, corr, user
        self._thread = thread

    def name(self):
        return self._name

    def start_ns(self):
        return self._a

    def end_ns(self):
        return self._b

    def device_type(self):
        return CUDA if self._dev else CPU

    def correlation_id(self):
        return self._corr

    def is_user_annotation(self):
        return self._user

    def start_thread_id(self):
        return self._thread


# one step call (ns): draws with a synchronise, then render with the field
# nested in it, then a backward whose kernel the autograd thread (2)
# launches while the main thread (1) holds the range, then a launch under
# no part; a copy with no launch call overlaps the first kernel
BENCH = [Evt("bench.g_step", 100, 2000)]
PARTS = [Evt("havatar.draws", 110, 200),
         Evt("havatar.render", 200, 800),
         Evt("havatar.render.field", 300, 700),
         Evt("havatar.backward", 900, 1500),
         # a range's device-side copy, marked as the profiler marks it
         Evt("havatar.render", 400, 700, device=True, user=True)]
CALLS = [Evt("cudaStreamSynchronize", 150, 160, corr=50),
         Evt("cudaLaunchKernel", 320, 330, corr=1),
         Evt("cudaLaunchKernelExC", 1000, 1010, corr=2, thread=2),
         Evt("cuLaunchKernel", 1600, 1610, corr=3)]
KERNELS = [Evt("k_field", 400, 500, device=True, corr=1),
           Evt("k_bwd", 1050, 1250, device=True, corr=2),
           Evt("k_tail", 1650, 1700, device=True, corr=3)]
UNLINKED = [Evt("Memcpy HtoD", 400, 450, device=True, corr=99)]


def _prof(events):
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: list(events))))


def _part(device=0, idle=0, launches=0, syncs=0):
    return {"device_s": pytest.approx(device * 1e-9),
            "idle_s": pytest.approx(idle * 1e-9),
            "launches": launches, "syncs": syncs}


# gaps: 500 -> 1050 opens under render.field (innermost), 1250 -> 1650
# under backward; device time goes to every part open at the launch call
WANT = {"draws": _part(syncs=1),
        "render": _part(device=100, launches=1),
        "render.field": _part(device=100, idle=550, launches=1),
        "backward": _part(device=200, idle=400, launches=1),
        UNNAMED: _part(device=50, launches=1),
        TOTAL: _part(device=350, idle=950, launches=3, syncs=1)}


@pytest.mark.parametrize("unlinked", [False, True])
def test_parts_and_linked_share(unlinked):
    events = BENCH + PARTS + CALLS + KERNELS + (UNLINKED if unlinked else [])
    t = trace_parts.reduce_parts(_prof(events), 2)
    assert t.parts == WANT
    assert t.linked_share == pytest.approx(350 / 400 if unlinked else 1.0)
    if unlinked:            # under 99% of the device time found its launch
        assert t.per_unit("render", "device_s") is None
    else:
        assert t.per_unit("render", "device_s") == pytest.approx(50e-9)
        assert t.per_unit(TOTAL, "launches") == 1.5
    assert t.per_unit("sr", "device_s") is None


@pytest.mark.parametrize("unlinked", [False, True])
def test_existing_fields_unchanged_by_parts_and_calls(unlinked):
    extra = UNLINKED if unlinked else []
    full = trace.reduce(_prof(BENCH + PARTS + CALLS + KERNELS + extra),
                        1e-5, 2)
    bare = trace.reduce(_prof(BENCH + KERNELS + extra), 1e-5, 2)
    assert full.busy_s == bare.busy_s == pytest.approx(350e-9)
    assert full.kernels == bare.kernels
    assert full.gaps == bare.gaps == {"g_step": pytest.approx(950e-9)}
    assert full.breakdown() == bare.breakdown()
    assert (full.window_s, full.units) == (bare.window_s, bare.units)
    # a program with no parts: its work in the step calls is all unnamed
    parts = trace_parts.reduce_parts(_prof(BENCH + CALLS + KERNELS + extra),
                                     2).parts
    assert set(parts) == {UNNAMED, TOTAL}
    assert parts[UNNAMED] == parts[TOTAL]
