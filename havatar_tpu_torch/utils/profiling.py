"""Step timing for the trainers.

The port's own ``StepTimer`` (``havatar_tpu/utils/profiling.py``): a rolling
mean of step times on the host clock. Where the JAX timer blocks on a
result, this one synchronizes the device, so the time covers the device's
work and not only its enqueue.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Optional

import torch


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
