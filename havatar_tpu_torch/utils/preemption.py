"""Preemption handling for training.

The port's own copy of ``havatar_tpu/utils/preemption.py``. A preemptible
machine receives SIGTERM before it shuts down; this turns the signal into a
graceful last checkpoint: the trainer polls ``should_stop()`` every step,
saves and exits cleanly, and a later run resumes from that checkpoint.
"""

from __future__ import annotations

import signal
import threading

_stop = threading.Event()
_installed = False


def install() -> None:
    """Install SIGTERM/SIGINT handlers (idempotent, main thread only)."""
    global _installed
    if _installed:
        return

    def _handler(signum, frame):
        _stop.set()

    try:
        signal.signal(signal.SIGTERM, _handler)
        signal.signal(signal.SIGINT, _handler)
        _installed = True
    except ValueError:
        pass  # not on the main thread


def should_stop() -> bool:
    return _stop.is_set()


def reset() -> None:
    _stop.clear()
