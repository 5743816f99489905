"""havatar_tpu_torch.data.prefetch.device_prefetch with no device named.

JAX's ``device_prefetch`` puts batches on the default device; the port's
default device is CUDA (``device.resolve_device``), so with no CUDA device
a call that names none raises as ``resolve_device`` does, when it is made,
instead of handing the batches to the CPU. Naming the CPU still works.
"""

import numpy as np
import pytest
import torch

from havatar_tpu_torch.data.prefetch import device_prefetch


def test_no_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    batches = iter([{"a": np.zeros(2, np.float32)}])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device_prefetch(batches)
    out = list(device_prefetch(batches, device="cpu"))
    assert len(out) == 1 and out[0]["a"].device.type == "cpu"
