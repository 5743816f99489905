"""Device input prefetching: overlap host IO and decoding with device work.

Port of ``havatar_tpu/data/prefetch.py``. A thread stays ``size`` batches
ahead of the consumer, turning host numpy batches into device tensors. On
CUDA each array is staged in a pinned host buffer and copied with
``non_blocking=True`` on a side stream; the batch carries the copy's event
and the consumer's stream waits on it before the batch is handed out, so
the frame loop never waits on PNG decode or the host-to-device copy.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch

from havatar_tpu_torch.device import DeviceLike, resolve_device


def device_prefetch(iterator: Iterator, size: int = 2,
                    device: DeviceLike = None, keys=None) -> Iterator:
    """Wrap a host batch iterator; yields batches whose ``keys`` (all array
    values when None) are tensors on ``device`` (None: the CUDA device, and
    it raises here, when called, without one), staying ``size`` batches
    ahead on a background thread. Other entries pass through as they are."""
    device = resolve_device(device)
    return _prefetch(iterator, size, device, keys)


def _prefetch(iterator: Iterator, size: int, device: torch.device,
              keys) -> Iterator:
    on_cuda = device.type == "cuda"
    copy_stream = torch.cuda.Stream(device) if on_cuda else None
    q: queue.Queue = queue.Queue(maxsize=size)
    _END = object()

    def _put(batch):
        out, event = {}, None
        staged = {k: torch.from_numpy(np.ascontiguousarray(v))
                  for k, v in batch.items()
                  if (keys is None and isinstance(v, np.ndarray))
                  or (keys is not None and k in keys)}
        if on_cuda:
            with torch.cuda.stream(copy_stream):
                for k, t in staged.items():
                    staged[k] = t.pin_memory().to(device, non_blocking=True)
                event = torch.cuda.Event()
                event.record(copy_stream)
        for k, v in batch.items():
            out[k] = staged.get(k, v)
        return out, event

    def worker():
        try:
            for batch in iterator:
                q.put(_put(batch))
        except BaseException as e:      # re-raised in the consumer
            q.put(e)
        finally:
            q.put(_END)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is _END:
            return
        if isinstance(item, BaseException):
            raise item
        batch, event = item
        if event is not None:
            torch.cuda.current_stream(device).wait_event(event)
            for v in batch.values():
                if isinstance(v, torch.Tensor):
                    v.record_stream(torch.cuda.current_stream(device))
        yield batch
