"""Training losses: the NeRF reconstruction terms and the GAN objectives.

Port of ``havatar_tpu/train/losses.py``, function by function: ``mse2psnr``,
``binary_cross_entropy`` with its clip, ``skin_weight_tv_loss``,
``stage1_lr``, ``downsample_bilinear`` and the GAN objectives
(``d_logistic_loss``, ``g_nonsaturating_loss``, ``d_r1_penalty``,
``g_path_regularize``, ``gan_loss_weight``), which stage 2 calls.

Images here are NHWC, as the renderer's are.
"""

from __future__ import annotations

import math
from typing import Callable, Tuple, Union

import torch
import torch.nn.functional as F

from havatar_tpu_torch.utils.profiling import span

Number = Union[float, torch.Tensor]


def mse2psnr(mse: Number) -> torch.Tensor:
    mse = torch.as_tensor(mse, dtype=torch.float32)
    return -10.0 * torch.log10(torch.clamp(mse, min=1e-12))


def binary_cross_entropy(pred: torch.Tensor, target: torch.Tensor,
                         clip: Tuple[float, float] = (1e-3, 1.0 - 1e-3)
                         ) -> torch.Tensor:
    p = torch.clamp(pred, *clip)
    return -torch.mean(target * torch.log(p)
                       + (1.0 - target) * torch.log(1.0 - p))


def skin_weight_tv_loss(weight_volume: torch.Tensor) -> torch.Tensor:
    """Mean |centre - 6-neighbourhood| total variation of the head-follow
    weight channel. weight_volume: [D, H, W] (channel 1 of the canonical
    volume)."""
    v = weight_volume
    core = v[1:-1, 1:-1, 1:-1]
    neighbours = (
        v[:-2, 1:-1, 1:-1], v[2:, 1:-1, 1:-1],
        v[1:-1, 2:, 1:-1], v[1:-1, :-2, 1:-1],
        v[1:-1, 1:-1, 2:], v[1:-1, 1:-1, :-2],
    )
    grad = sum(torch.abs(core - n) for n in neighbours) / 6.0
    return torch.mean(grad)


# ---- GAN objectives --------------------------------------------------------

def d_logistic_loss(real_pred: torch.Tensor,
                    fake_pred: torch.Tensor) -> torch.Tensor:
    return F.softplus(-real_pred).mean() + F.softplus(fake_pred).mean()


def g_nonsaturating_loss(fake_pred: torch.Tensor) -> torch.Tensor:
    return F.softplus(-fake_pred).mean()


def d_r1_penalty(d_apply: Callable[[torch.Tensor], torch.Tensor],
                 real_img: torch.Tensor) -> torch.Tensor:
    """R1 = E[||d D(x) / d x||^2] at the real images, differentiable with
    respect to the discriminator's parameters (the gradient is taken with
    ``create_graph``). ``d_apply`` maps images to scores; the JAX function's
    ``d_params`` are the module's own parameters here."""
    img = real_img.detach().requires_grad_(True)
    score = d_apply(img).sum()
    with span("backward"):
        (grads,) = torch.autograd.grad(score, img, create_graph=True)
    return grads.square().sum() / real_img.shape[0]


def g_path_regularize(fake_img: torch.Tensor, latent_grads: torch.Tensor,
                      mean_path_length: torch.Tensor, decay: float = 0.01):
    """Path-length regularisation. ``latent_grads`` are
    d(sum noise * img) / d(latents), [B, n_latent, D]. Returns (penalty, the
    new mean path length detached, path lengths). The training loop has it
    switched off; it is here for parity."""
    path_lengths = torch.sqrt(latent_grads.square().sum(2).mean(1))
    new_mean = mean_path_length + decay * (path_lengths.mean()
                                           - mean_path_length)
    penalty = (path_lengths - new_mean).square().mean()
    return penalty, new_mean.detach(), path_lengths


def gan_loss_weight(step: Number) -> Number:
    """Ramped adversarial weight min(1e-3 * 1.1^(step // 500), 0.1)."""
    if isinstance(step, torch.Tensor):
        ramp = 1e-3 * 1.1 ** torch.div(step, 500, rounding_mode="floor")
        return torch.clamp(ramp, max=0.1)
    # 1.1^49 > 100, so the cap is reached there: a larger exponent changes
    # nothing, and Python's float power overflows on a huge one
    return min(1e-3 * 1.1 ** min(step // 500, 49), 0.1)


def stage1_lr(step: Number, base_lr: float, decay_factor: float = 0.1,
              decay_kilosteps: int = 250, floor: float = 5e-5) -> Number:
    """Exponential decay with a floor:
    max(base_lr * decay_factor^(step / (decay_kilosteps * 1000)), floor)."""
    if isinstance(step, torch.Tensor):
        lr = base_lr * decay_factor ** (step / (decay_kilosteps * 1000.0))
        return torch.clamp(lr, min=floor)
    return max(base_lr * math.pow(decay_factor,
                                  step / (decay_kilosteps * 1000.0)), floor)


def downsample_bilinear(img: torch.Tensor, size: int) -> torch.Tensor:
    """NHWC [B, H, W, C] -> [B, size, size, C]: bilinear at the
    ``align_corners=True`` positions (torch ``F.interpolate`` on the NCHW
    transpose gives the same)."""
    B, H, W, C = img.shape
    ys = torch.linspace(0.0, H - 1.0, size, device=img.device)
    xs = torch.linspace(0.0, W - 1.0, size, device=img.device)
    y0, x0 = ys.floor().long(), xs.floor().long()
    y1, x1 = (y0 + 1).clamp(max=H - 1), (x0 + 1).clamp(max=W - 1)
    wy = (ys - y0)[None, :, None, None].to(img.dtype)
    wx = (xs - x0)[None, None, :, None].to(img.dtype)

    def g(yi, xi):
        return img[:, yi][:, :, xi]

    return (g(y0, x0) * (1 - wy) * (1 - wx) + g(y0, x1) * (1 - wy) * wx
            + g(y1, x0) * wy * (1 - wx) + g(y1, x1) * wy * wx)
