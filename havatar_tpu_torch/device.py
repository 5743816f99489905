"""Device selection for the port's entry points.

The port runs on CUDA. An entry point given no device picks the current CUDA
device and raises when there is none: a silent fall back to the CPU would
hand a caller who asked for the GPU numbers from another machine. The CPU is
used only when the caller names it (``device="cpu"``), as the tests do.
Under a process group (one process a GPU, ``torchrun``) the CUDA device is
the rank's own, ``LOCAL_RANK``.
"""

from __future__ import annotations

import os
from typing import Optional, Union

import torch
import torch.distributed as dist

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> the CUDA device (raises without CUDA): ``LOCAL_RANK``'s
    under a process group, else the current one; else ``device``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "havatar_tpu_torch runs on CUDA and no CUDA device is "
                "available; pass device='cpu' to run on the CPU explicitly")
        if dist.is_available() and dist.is_initialized():
            return torch.device("cuda", int(os.environ.get("LOCAL_RANK",
                                                           "0")))
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)
