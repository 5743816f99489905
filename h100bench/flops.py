"""The model's useful operations a call or step, counted once from a cell's
shapes: the convolutions and linears by ``FlopCounterMode`` over the plain
reference on the ``meta`` device (no memory, no time), the field MLP on the
samples by its formula (``roofline/field_mlp.py``). The count does not
change when a later change replaces an op by a kernel.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from h100bench.reference import steps as ref
from h100bench.reference.losses import d_r1_penalty
from h100bench.reference.lpips import lpips
from h100bench.roofline.field_mlp import from_config
from h100bench.weights import lpips_params

META = torch.device("meta")


class _Counter(TorchDispatchMode):
    """``FlopCounterMode``'s formulas (``flop_registry``) without its module
    hooks, which a gradient of a gradient (R1) trips."""

    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.total += formula(*args, **kwargs, out_val=out)
        return out


def _count(fn) -> float:
    with _Counter() as c:
        fn()
    return float(c.total)


def _planes(renderer, B: int, cfg: Dict, grad: bool):
    c = cfg["config"]
    res = c["dataset"]["cond_render_res"]
    lat = c["experiment"]["latent_code_dim"]

    def run():
        conds = [torch.zeros(B, res, res, 7, device=META) for _ in range(3)]
        out = renderer.model_coarse.generate_planes(
            torch.zeros(B, lat, device=META, requires_grad=grad),
            torch.zeros(B, 12, device=META), *conds)
        if grad:
            out.sum().backward()
    return run


def _mlp_rows(cfg: Dict, B: int, R: int, num_coarse: int,
              num_fine: int) -> float:
    """Multiply-add ops x 2 of the field MLP on every sample of a render."""
    return 2.0 * B * R * (num_coarse + num_fine) * from_config(cfg).macs()


def _volume(renderer, grad: bool):
    def run():
        v = renderer.skin_volume()
        if grad:
            v.sum().backward()
    return run


def stage2_iteration(cfg: Dict) -> float:
    """Operations of one D + G iteration, R1's share (1 / d_reg_every)
    included: the D step's render (forward), generator and two D passes
    with D's backward; the G step's render, generator, D and LPIPS forward
    and backward; the skinning volume decoded in each render."""
    c = cfg["config"]
    gan, su = c["gan"], c["models"]["StyleUnet"]
    B, side, out = gan["batch"], su["inp_size"], su["out_size"]
    nerf = c["nerf"]["train"]
    with torch.device(META):
        renderer = ref.build_renderer(c)
        gen, disc = ref.build_generator(c), ref.build_discriminator(c)
    lp = lpips_params(META, 0)

    def g_fwd():
        return gen(torch.zeros(B, gan["latent"], device=META),
                   torch.zeros(B, su["inp_ch"], side, side, device=META,
                               requires_grad=True))

    def d_step():
        fake = g_fwd().detach()
        real = torch.zeros(B, 3, out, out, device=META)
        (disc(fake).sum() + disc(real).sum()).backward()

    def g_step():
        fake = g_fwd()
        img = fake.permute(0, 2, 3, 1)
        (disc(fake).sum() + lpips(lp, img, img.detach())).backward()

    def r1():
        d_r1_penalty(disc, torch.zeros(B, 3, out, out,
                                       device=META)).backward()

    mlp = _mlp_rows(cfg, B, side * side, nerf["num_coarse"],
                    nerf["num_fine"])
    fwd = (_count(_planes(renderer, B, cfg, grad=False))
           + _count(_volume(renderer, grad=False)) + mlp)
    fwd_bwd = (_count(_planes(renderer, B, cfg, grad=True))
               + _count(_volume(renderer, grad=True)) + 3 * mlp)
    return (fwd + _count(d_step) + fwd_bwd + _count(g_step)
            + _count(r1) / gan["d_reg_every"])


def stage1_step(cfg: Dict, traffic: Dict) -> float:
    """Operations of one stage-1 step: the plane generators, the skinning
    volume and the field MLP forward and backward, and the patch LPIPS."""
    c = cfg["config"]
    nerf = c["nerf"]["train"]
    B, p = traffic["batch"], traffic["patch"]
    with torch.device(META):
        renderer = ref.build_renderer(c)
    lp = lpips_params(META, 0)

    def patch():
        img = torch.zeros(B, p, p, 3, device=META, requires_grad=True)
        lpips(lp, img, torch.zeros(B, p, p, 3, device=META)).backward()

    return (_count(_planes(renderer, B, cfg, grad=True))
            + _count(_volume(renderer, grad=True)) + _count(patch)
            + 3 * _mlp_rows(cfg, B, p * p, nerf["num_coarse"],
                            nerf["num_fine"]))


# the operations of one call or step, by the traffic file's ``kind``
UNIT_OPS = {"stage1": stage1_step,
            "stage2": lambda cfg, traffic: stage2_iteration(cfg)}
