"""What the preprocessing networks share: seeded weights in the reference's
layout, and reading and loading a reference state dict.

The networks (landmark_net.py, retinaface.py, rvm.py) are torch modules
whose ``state_dict`` keys are the reference's own, with every BatchNorm
kept (in eval mode) beside its conv, so a reference weights file loads
with ``load_state_dict``. Their weights are downloads in the reference, so
the tests and ``chip_smoke.py`` run them on seeded weights: ``seed_``
draws them with numpy from a seed, the same on every machine.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn


def seed_(module: nn.Module, seed: int) -> nn.Module:
    """Draw every conv and BatchNorm of ``module`` from ``seed``, in
    ``named_modules`` order: conv weights N(0, 1 / fan_in) (JAX's
    ``init_landmark_params`` scale), conv biases N(0, 0.01^2), BatchNorm
    scale U(0.5, 1.5), shift N(0, 0.1^2), running mean N(0, 0.1^2) and
    running variance U(0.5, 1.5), so folding a BatchNorm is not the
    identity. Returns the module in eval mode."""
    rng = np.random.RandomState(seed)

    def draw(t, a):
        t.copy_(torch.from_numpy(np.asarray(a, np.float32).reshape(t.shape)))

    with torch.no_grad():
        for _, m in module.named_modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.weight[0].numel()
                draw(m.weight, rng.randn(*m.weight.shape) / math.sqrt(fan_in))
                if m.bias is not None:
                    draw(m.bias, rng.randn(*m.bias.shape) * 0.01)
            elif isinstance(m, nn.BatchNorm2d):
                c = m.num_features
                draw(m.weight, rng.rand(c) + 0.5)
                draw(m.bias, rng.randn(c) * 0.1)
                draw(m.running_mean, rng.randn(c) * 0.1)
                draw(m.running_var, rng.rand(c) + 0.5)
    return module.eval()


def read_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A ``.pth`` state dict (or a pickled module), or an ``.npz`` of the
    same tensors, as CPU tensors."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k: torch.from_numpy(z[k]) for k in z.files}
    sd = torch.load(path, map_location="cpu")
    return sd.state_dict() if hasattr(sd, "state_dict") else sd


def load_reference(module: nn.Module, state_dict: Mapping) -> nn.Module:
    """Load a reference state dict: every key the module has must be there
    (a missing one raises); keys it does not have (heads the reference's
    file carries but these networks never run, such as a classifier or a
    segmentation projection) are ignored. Returns the module in eval mode."""
    sd = {k: torch.as_tensor(np.asarray(v)) if not isinstance(v, torch.Tensor)
          else v for k, v in state_dict.items()}
    missing, _ = module.load_state_dict(sd, strict=False)
    if missing:
        raise KeyError(f"{type(module).__name__}: the weights lack "
                       f"{len(missing)} keys, e.g. {missing[:4]}")
    return module.eval()
