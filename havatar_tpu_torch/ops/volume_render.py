"""Alpha compositing and hierarchical inverse-CDF sampling.

Port of ``havatar_tpu/ops/volume_render.py``: ``cumprod_exclusive``,
``volume_render_radiance_field`` (with training's gaussian noise on sigma)
and ``sample_pdf`` in its deterministic and its stratified branch. The random
numbers are arguments: the caller draws them (``models/renderer.py:
draw_render_noise``), so a test can hand in another package's draws.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


class _Cumprod(torch.autograd.Function):
    """``torch.cumprod`` along the last axis of an input with no zero. The
    backward is PyTorch's own for that case, the reversed cumulative sum of
    output * grad over the input, without the check for zeros that PyTorch's
    backward makes first: a host read, which drains the device's queue."""

    @staticmethod
    def forward(ctx, x):
        out = torch.cumprod(x, dim=-1)
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        return (out * g).flip(-1).cumsum(-1).flip(-1).div(x)


def cumprod_exclusive(x: torch.Tensor) -> torch.Tensor:
    """Exclusive cumulative product along the last axis of an x with no
    zero (compositing's 1 - alpha + 1e-10): where x holds a zero, the
    gradient is not finite."""
    cp = _Cumprod.apply(x)
    return torch.cat([torch.ones_like(cp[..., :1]), cp[..., :-1]], dim=-1)


def volume_render_radiance_field(
    radiance_field: torch.Tensor,
    depth_values: torch.Tensor,
    ray_directions: torch.Tensor,
    background_prior: Optional[torch.Tensor] = None,
    radiance_field_noise_std: float = 0.0,
    noise: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
           torch.Tensor]:
    """radiance [R, S, C+1] (rgb 0:3 through sigmoid, features linear,
    sigma last), depths [R, S], un-normalized directions [R, 3]. With
    ``radiance_field_noise_std > 0``, ``noise`` [R, S] (standard normal
    draws) times that std is added to sigma before its relu.

    Returns (rgb_map [R, C], disp_map [R], acc_map [R], weights [R, S],
    depth_map [R]); the background is composited onto rgb only.
    """
    dists = depth_values[..., 1:] - depth_values[..., :-1]
    dists = torch.cat([dists, dists[..., -1:]], dim=-1)
    dists = dists * torch.linalg.norm(ray_directions, dim=-1)[..., None]

    sigma = radiance_field[..., -1]
    if radiance_field_noise_std > 0.0:
        if noise is None:
            raise ValueError("sigma noise needs its draws: pass noise [R, S]")
        sigma = sigma + noise.to(sigma.dtype) * radiance_field_noise_std
    sigma = torch.relu(sigma)
    alpha = 1.0 - torch.exp(-sigma * dists)
    weights = alpha * cumprod_exclusive(1.0 - alpha + 1e-10)

    rgb3 = torch.einsum("rs,rsc->rc", weights,
                        torch.sigmoid(radiance_field[..., :3]))
    featm = torch.einsum("rs,rsc->rc", weights, radiance_field[..., 3:-1])
    rgb_map = torch.cat([rgb3, featm], dim=-1)
    depth_map = (weights * depth_values).sum(dim=-1)
    acc_map = weights.sum(dim=-1)
    disp_map = 1.0 / torch.clamp(depth_map / acc_map, min=1e-10)
    if background_prior is not None:
        rgb_map = torch.cat(
            [rgb_map[..., :3] + (1.0 - acc_map[..., None]) * background_prior,
             rgb_map[..., 3:]], dim=-1)
    return rgb_map, disp_map, acc_map, weights, depth_map


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor,
               num_samples: int, det: bool = True,
               u01: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Inverse-CDF sampling of ``num_samples`` depths through the CDF of
    ``weights + 1e-5``. ``det``: evenly spaced u in [0, 1]; else stratified,
    u_i = i/n + u01_i * (1/n - 1e-6) with ``u01`` [R, num_samples] uniform
    draws in [0, 1).

    bins: [R, K] midpoints; weights: [R, K-1]. Returns [R, num_samples].
    The bin lookup is searchsorted(cdf, u, side='right'); a CDF step below
    1e-5 is treated as 1 (no division by ~0).
    """
    weights = weights + 1e-5
    pdf = weights / weights.sum(dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)  # [R, K]
    K = cdf.shape[-1]
    if det:
        u = torch.linspace(0.0, 1.0, num_samples, dtype=weights.dtype,
                           device=weights.device)
        u = u.expand(cdf.shape[:-1] + (num_samples,)).contiguous()
    else:
        if u01 is None:
            raise ValueError("stratified sampling needs its draws: pass u01 "
                             "[R, num_samples]")
        step = 1.0 / num_samples
        base = torch.arange(num_samples, dtype=weights.dtype,
                            device=weights.device) * step
        u = (base[None, :] + u01.to(weights.dtype) * (step - 1e-6)).contiguous()

    inds = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = (inds - 1).clamp(min=0)
    above = inds.clamp(max=K - 1)
    cdf_below = torch.gather(cdf, -1, below)
    cdf_above = torch.gather(cdf, -1, above)
    bins_below = torch.gather(bins, -1, below)
    bins_above = torch.gather(bins, -1, above)

    denom = cdf_above - cdf_below
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_below) / denom
    return bins_below + t * (bins_above - bins_below)
