"""Bilinear / trilinear grid sampling with ``align_corners=True``.

Port of the samplers of ``havatar_tpu/ops/grid_sample.py`` that rendering
uses:

* ``grid_sample_2d_quad``: the gather half of 2D bilinear sampling
  (``zeros`` or ``border`` padding). It returns each point's four raw
  corner rows [N, 4C] and its corner weights [N, 4]
  (``nerf_field.field_inputs_quad``, the input of JAX's quad march
  kernels); ``grid_sample_2d_quad.calls`` counts its calls, so that a run
  can show that no corner rows were made.
* ``grid_sample_2d``: the whole sampler, the gather plus an f32 corner
  reduction rounded to the features' dtype; ``sample_from_triplane`` applies
  it to each feature plane, ``sample_image_features`` to each view's image
  features.
* ``grid_sample_3d``: trilinear ``border``-padding sampling (skinning).

Per-axis weights are computed against the *unclamped* floor index, so a
fetched corner that is not the true corner gets weight 0 exactly: that is
``zeros`` padding with no branches, and ``border`` padding once coordinates
are clamped. The TPU package packs corners into one row per fetch; that is
a TPU layout trick and not part of the function, so here each corner is
plain torch indexing.

Coordinates are in [-1, 1]; coords[..., 0] = x indexes W, [..., 1] = y
indexes H, [..., 2] = z indexes D.
"""

from __future__ import annotations

from typing import Tuple

import torch

from havatar_tpu_torch.utils.profiling import device_numbers


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
    grid_sample_2d_quad.calls += 1
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


grid_sample_2d_quad.calls = 0


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
    cols = [device_numbers(ax, coords.device, torch.int64) for ax in axes]
    return torch.stack([grid_sample_2d(planes[p], coords[..., c])
                        for p, c in enumerate(cols)], dim=-1)


def sample_image_features(xy: torch.Tensor, features: torch.Tensor,
                          padding_mode: str = "border") -> torch.Tensor:
    """Multi-view image features: xy [B, V, N, 2] normalised coordinates,
    features [B, V, C, H, W] -> [B, V, N, C] (the reference's
    ``img_feature``, utils/util.py:345-356)."""
    feat = features.permute(0, 1, 3, 4, 2)
    return torch.stack(
        [grid_sample_2d(feat[:, v], xy[:, v], padding_mode)
         for v in range(xy.shape[1])], dim=1)


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
