"""Bilinear and trilinear grid sampling with ``align_corners=True``: the
planes' zeros-padded bilinear lookups (``sample_from_triplane``) and the
skinning volume's border-padded trilinear one (``grid_sample_3d``). Per-axis
weights are taken against the unclamped floor index, so a fetched corner
that is not the true corner weighs exactly 0.

Frozen here in plain PyTorch from the program's module of the same name
(``havatar_tpu_torch``); the benchmark's reference imports nothing of it.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _unnormalize(coord: torch.Tensor, size: int) -> torch.Tensor:
    return (coord + 1.0) * 0.5 * (size - 1)


def _axis_weights(pix: torch.Tensor, size: int):
    """(start, w0, w1): the corner pair (start, start+1) with
    start = clip(floor(pix), 0, size-2) and each corner's weight, nonzero
    only where the corner is floor(pix) (1-frac) or floor(pix)+1 (frac)."""
    fl = torch.floor(pix)
    frac = pix - fl
    a0 = fl.clamp(0, size - 2)
    zero = torch.zeros_like(pix)
    w0 = (torch.where(a0 == fl, 1.0 - frac, zero)
          + torch.where(a0 == fl + 1.0, frac, zero))
    a1 = a0 + 1.0
    w1 = (torch.where(a1 == fl, 1.0 - frac, zero)
          + torch.where(a1 == fl + 1.0, frac, zero))
    return a0.long(), w0, w1


def grid_sample_2d_quad(feat: torch.Tensor, coords: torch.Tensor,
                        padding_mode: str = "zeros"
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """feat [B, H, W, C], coords [B, N, 2] -> (rows [B, N, 4C] in feat's
    dtype, w4 [B, N, 4] float32), ``zeros`` or ``border`` padding.

    Corner order (y0x0, y0x1, y1x0, y1x1); the bilinear value is
    ``einsum('bnkc,bnk->bnc', rows.view(B, N, 4, C).float(), w4)``.
    """
    if padding_mode not in ("zeros", "border"):
        raise ValueError(f"unknown padding_mode {padding_mode!r}")
    B, H, W, C = feat.shape
    N = coords.shape[1]
    x = _unnormalize(coords[..., 0], W)
    y = _unnormalize(coords[..., 1], H)
    if padding_mode == "border":
        x = x.clamp(0.0, W - 1)
        y = y.clamp(0.0, H - 1)
    x0, wx0, wx1 = _axis_weights(x, W)
    y0, wy0, wy1 = _axis_weights(y, H)
    base = y0 * W + x0                                        # [B, N]
    idx = torch.stack([base, base + 1, base + W, base + W + 1], dim=-1)
    flat = feat.reshape(B, H * W, C)
    bidx = torch.arange(B, device=feat.device)[:, None, None]
    rows = flat[bidx, idx].reshape(B, N, 4 * C)
    w4 = torch.stack([wy0 * wx0, wy0 * wx1, wy1 * wx0, wy1 * wx1], dim=-1)
    return rows, w4.float()




def grid_sample_2d(feat: torch.Tensor, coords: torch.Tensor,
                   padding_mode: str = "zeros") -> torch.Tensor:
    """feat [B, H, W, C], coords [B, N, 2] -> [B, N, C] in feat's dtype:
    bilinear, ``zeros`` or ``border`` padding, align_corners (torch
    ``F.grid_sample`` on a [B, N, 1, 2] grid). The four corners are summed
    in float32 and the sum rounded to feat's dtype, which is where the quad
    march kernels round their corner reduction too."""
    rows, w4 = grid_sample_2d_quad(feat, coords, padding_mode)
    C = feat.shape[-1]
    acc = rows[..., :C].float() * w4[..., 0:1]
    for k in range(1, 4):
        acc = acc + rows[..., k * C:(k + 1) * C].float() * w4[..., k:k + 1]
    return acc.to(feat.dtype)


def sample_from_triplane(coords: torch.Tensor,
                         planes: torch.Tensor) -> torch.Tensor:
    """coords [B, N, 3] box-warped, planes [P, B, H, W, C] with P <= 3 ->
    [B, N, C, P]. Plane 0 reads (x, y), plane 1 (z, y), plane 2 (x, z); each
    plane has its top-left at (-1, -1). Zeros padding."""
    axes = ((0, 1), (2, 1), (0, 2))[:planes.shape[0]]
    return torch.stack(
        [grid_sample_2d(planes[p], coords[..., list(ax)])
         for p, ax in enumerate(axes)], dim=-1)


def grid_sample_3d(vol: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """vol [B, D, H, W, C], coords [B, N, 3] -> [B, N, C] in vol's dtype,
    trilinear with border padding (matches torch ``F.grid_sample`` 3D,
    align_corners=True, padding_mode='border'). Weights and sums in float32.
    """
    B, D, H, W, C = vol.shape
    x = _unnormalize(coords[..., 0], W).clamp(0.0, W - 1)
    y = _unnormalize(coords[..., 1], H).clamp(0.0, H - 1)
    z = _unnormalize(coords[..., 2], D).clamp(0.0, D - 1)
    x0, wx0, wx1 = _axis_weights(x, W)
    y0, wy0, wy1 = _axis_weights(y, H)
    z0, wz0, wz1 = _axis_weights(z, D)
    flat = vol.reshape(B, D * H * W, C)
    bidx = torch.arange(B, device=vol.device)[:, None]

    def row(zz, yy):
        base = (zz * H + yy) * W + x0
        # x interpolation of one (z, y) corner row
        return (flat[bidx, base].float() * wx0[..., None]
                + flat[bidx, base + 1].float() * wx1[..., None])

    acc = (row(z0, y0) * (wz0 * wy0)[..., None]
           + row(z0, y0 + 1) * (wz0 * wy1)[..., None]
           + row(z0 + 1, y0) * (wz1 * wy0)[..., None]
           + row(z0 + 1, y0 + 1) * (wz1 * wy1)[..., None])
    return acc.to(vol.dtype)
