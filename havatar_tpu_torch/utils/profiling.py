"""Step timing and named spans for the trainers and the renderer.

The port's own ``StepTimer`` (``havatar_tpu/utils/profiling.py``): a rolling
mean of step times on the host clock. Where the JAX timer blocks on a
result, this one synchronizes the device, so the time covers the device's
work and not only its enqueue.

``span(name)`` is the twin of the JAX package's ``annotate``: a host range
``havatar.<name>`` in a ``torch.profiler`` trace. Wrap any
``torch.profiler.profile`` around training steps or frames and its trace
(``export_chrome_trace``, or the raw events) holds these ranges on the clock
of the device's kernels, copies and fills, so each kernel and each idle gap
can be put down to a part of the step. The spans in the port:

==================  ==================================================
``render``          ``AvatarRenderer.forward``
``render.planes``   the plane generators, inside ``render``
``render.skinning`` each skinning of sample points into canonical space
``render.field``    each field evaluation: the dense chain or quad op on
                    the exact path, the march kernels on the fused path
``sr``              ``StyleUNetSR.forward``
``disc``            ``WaveletDiscriminator.forward``
``lpips``           ``train/lpips.py:lpips_loss``
``draws``           a stage-2 step's random draws (``make_steps``)
``backward``        every backward pass of the training steps, R1's
                    gradient of the gradient included
``optim``           the optimizer updates (stage 2: with G's EMA; stage 1:
                    with the learning rate's update)
==================  ==================================================

With no profiler running, ``span`` returns one shared no-op context: a
flag check and no allocation, so the spans stay in the code at no cost.

``device_constant`` and ``device_numbers`` hold the small constant tensors
that the ops use inside a step (the Haar filters, the box warp's scale and
offset, LPIPS's input shift and scale, the column indices of the plane
lookups and of the quad op's layer 0), made once for each device and dtype:
a copy from the host inside a step, as a host tensor or a Python list used
as an index makes, would synchronize and drain the device's queue.
``constant_uploads()`` counts the tensors made so far; after a first step it
stays flat.
"""

from __future__ import annotations

import contextlib
import time
from collections import deque
from typing import Callable, Dict, Hashable, Optional, Tuple

import torch

PREFIX = "havatar."
_OFF = contextlib.nullcontext()
_profiling = torch._C._autograd._profiler_enabled


def span(name: str):
    """The host range ``havatar.<name>`` while a ``torch.profiler`` runs;
    otherwise one shared context that does nothing."""
    if not _profiling():
        return _OFF
    return torch.profiler.record_function(PREFIX + name)


_CONSTANTS: Dict[Tuple[Hashable, torch.device, torch.dtype],
                 torch.Tensor] = {}


def device_constant(key: Hashable, device: torch.device, dtype: torch.dtype,
                    make: Callable[[], torch.Tensor]) -> torch.Tensor:
    """``make()`` (a host tensor) on ``device`` in ``dtype``, made on the
    first call for each (key, device, dtype) and the same tensor after.
    ``device`` is a tensor's ``.device`` (with its index, so each card of a
    sharded run holds its own copy). The tensor is made outside any
    ``inference_mode``, so that a later training step may save it for its
    backward."""
    k = (key, device, dtype)
    t = _CONSTANTS.get(k)
    if t is None:
        with torch.inference_mode(False):
            t = make().to(device=device, dtype=dtype)
        _CONSTANTS[k] = t
    return t


def device_numbers(values: tuple, device: torch.device,
                   dtype: torch.dtype) -> torch.Tensor:
    """``torch.tensor(values, dtype=dtype)`` on ``device``, made there once
    (``device_constant``): a tuple of numbers such as a box warp's scale or
    an index into a tensor's columns."""
    return device_constant(("numbers", values), device, dtype,
                           lambda: torch.tensor(values, dtype=dtype))


def constant_uploads() -> int:
    """How many constants ``device_constant`` has made so far."""
    return len(_CONSTANTS)


class StepTimer:
    def __init__(self, window: int = 100,
                 device: Optional[torch.device] = None):
        self.window = window
        self.device = device
        self.times: deque = deque(maxlen=window)
        self._t0: Optional[float] = None

    def _sync(self) -> None:
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self) -> None:
        self._sync()
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        """Stops timing after the device has finished its queued work."""
        self._sync()
        dt = time.perf_counter() - self._t0
        self.times.append(dt)
        return dt

    @property
    def mean(self) -> float:
        return sum(self.times) / max(len(self.times), 1)

    @property
    def steps_per_sec(self) -> float:
        m = self.mean
        return 1.0 / m if m > 0 else 0.0
