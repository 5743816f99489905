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
"""

from __future__ import annotations

import contextlib
import time
from collections import deque
from typing import Optional

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
