"""Seeded weights, made on the device in a few large draws.

The program under test and the plain reference build modules with the same
``state_dict`` names and shapes (the reference's key layout), so filling
both from one seed gives both the same weights bit for bit. The
initialisers are the JAX package's, keyed by the class that owns a
parameter: N(0, 1) for equalized-lr weights (EqualLinear's divided by
lr_mul), constant inputs and modulated convolutions, LeCun normal for the
field's dense layers (bias 0, but ``DENSITY_BIAS`` for the density head
``fc_alpha``), Xavier normal for the volume decoder's 3D
convolutions (bias 0), U(0, 1) for its seed. What a constructor sets to a
constant (biases, noise strengths) stays.

The LPIPS network's weights are not bundled with the program, so its VGG16
layout is filled here too, He normal (bias 0) with non-negative heads.
"""

from __future__ import annotations

import math
import zlib
from typing import Dict, List, Tuple

import torch
import torch.nn as nn

# The density head's bias. A random field with a zero bias is, by the seed's
# coin flip, empty (every frame black) or dense, since every point's hidden
# activations share one sign pattern; a trained avatar has density where
# the head is. With this bias every seed's field has density in the box.
DENSITY_BIAS = 1.0

# VGG16 conv plan of the LPIPS tree: (out_channels, layers) a block
VGG_PLAN = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one part (``tag``) of a run of ``seed``."""
    return (int(seed) * 1_000_003 + zlib.crc32(tag.encode())) % (2 ** 63)


def generator(device, seed: int, tag: str) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, tag))
    return g


def _plan(module: nn.Module) -> Tuple[List, List, List]:
    """(normal leaves with their std, constant leaves with their value,
    uniform leaves), in the order of the modules' names."""
    normal, const, uniform = [], [], []
    for name, m in sorted(module.named_modules(), key=lambda kv: kv[0]):
        kind = type(m).__name__
        if kind == "EqualLinear":
            normal.append((m.weight, 1.0 / m.lr_mul))
        elif kind in ("EqualConv2d", "ModulatedConv2d"):
            normal.append((m.weight, 1.0))
        elif kind == "ConstantInput":
            normal.append((m.input, 1.0))
        elif kind == "Linear":
            normal.append((m.weight, 1.0 / math.sqrt(m.in_features)))
            const.append((m.bias, DENSITY_BIAS if name.endswith("fc_alpha")
                          else 0.0))
        elif kind == "Conv3d":
            fan_in = m.weight[0].numel()
            fan_out = m.weight.shape[0] * m.weight[0, 0].numel()
            normal.append((m.weight, math.sqrt(2.0 / (fan_in + fan_out))))
            const.append((m.bias, 0.0))
        elif kind == "VolumeDecoder":
            uniform.append(m.init_lc)
    return normal, const, uniform


@torch.no_grad()
def fill_(module: nn.Module, seed: int, tag: str) -> nn.Module:
    """Draw every random parameter of ``module`` (on its device) from
    (``seed``, ``tag``): one normal draw for all normal leaves, one uniform
    draw for the rest."""
    normal, const, uniform = _plan(module)
    dev = next(module.parameters()).device
    g = generator(dev, seed, tag)
    flat = torch.randn(sum(t.numel() for t, _ in normal), generator=g,
                       device=dev)
    at = 0
    for t, std in normal:
        n = t.numel()
        t.copy_(flat[at:at + n].view_as(t) * std)
        at += n
    for t, value in const:
        t.fill_(value)
    if uniform:
        u = torch.rand(sum(t.numel() for t in uniform), generator=g,
                       device=dev)
        at = 0
        for t in uniform:
            t.copy_(u[at:at + t.numel()].view_as(t))
            at += t.numel()
    return module


def lpips_params(device, seed: int) -> Dict:
    """The LPIPS tree ``{"conv": {"b{i}_c{j}": {"weight" HWIO, "bias"}},
    "lin": {"l{i}": [1, 1, C, 1]}}`` (the program's layout and the
    reference's), He normal convolutions and |N(0, 1)| / 100 heads."""
    shapes, in_ch = [], 3
    for out_ch, n in VGG_PLAN:
        for _ in range(n):
            shapes.append((3, 3, in_ch, out_ch))
            in_ch = out_ch
    n = sum(math.prod(s) for s in shapes) + sum(c for c, _ in VGG_PLAN)
    if torch.device(device).type == "meta":     # shapes alone (flops.py)
        flat = torch.empty(n, device=device)
    else:
        flat = torch.randn(n, generator=generator(device, seed, "lpips"),
                           device=device)
    params: Dict = {"conv": {}, "lin": {}}
    at, k = 0, 0
    for bi, (out_ch, n) in enumerate(VGG_PLAN):
        for li in range(n):
            s = shapes[k]
            w = flat[at:at + math.prod(s)].view(s) * math.sqrt(
                2.0 / (9 * s[2]))
            params["conv"][f"b{bi}_c{li}"] = {
                "weight": w.clone(),
                "bias": torch.zeros(out_ch, device=device)}
            at += math.prod(s)
            k += 1
        params["lin"][f"l{bi}"] = (flat[at:at + out_ch].abs() * 0.01).view(
            1, 1, out_ch, 1).clone()
        at += out_ch
    return params
