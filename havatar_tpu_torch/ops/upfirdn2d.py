"""Upsample -> FIR filter -> downsample (the StyleGAN resampling primitive)
and the Haar wavelet transforms, on NCHW tensors.

Port of ``havatar_tpu/ops/upfirdn2d.py``. One depthwise convolution does the
filtering: zero-stuffing makes the upsample, ``F.pad`` (negative values crop)
the padding, and the stride the downsample. The Haar filters are made on
the input's device once for each device and dtype
(``utils/profiling.py:device_constant``), never copied from the host in a
step.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from havatar_tpu_torch.utils.profiling import device_constant


def make_kernel(k) -> torch.Tensor:
    """Normalized 2D FIR kernel from 1D taps (outer product) or 2D taps."""
    k = torch.as_tensor(k, dtype=torch.float32)
    if k.ndim == 1:
        k = k[None, :] * k[:, None]
    return k / k.sum()


def _as_pair(v) -> Tuple[int, int]:
    if isinstance(v, (tuple, list)):
        return int(v[0]), int(v[1])
    return int(v), int(v)


def upfirdn2d(x: torch.Tensor, kernel: torch.Tensor, up=1, down=1,
              pad: Sequence[int] = (0, 0)) -> torch.Tensor:
    """x [B, C, H, W]; kernel [kh, kw]; up/down an int or an (x, y) pair;
    pad (p0, p1) on both axes or (x0, x1, y0, y1).

    Output height (H * up_y + pad_y0 + pad_y1 - kh) // down_y + 1.
    """
    # convolution with the kernel == cross-correlation with it flipped
    return _correlate(x, torch.flip(kernel, (0, 1)).to(device=x.device,
                                                       dtype=x.dtype),
                      up, down, pad)


def _correlate(x: torch.Tensor, w: torch.Tensor, up, down,
               pad: Sequence[int]) -> torch.Tensor:
    """``upfirdn2d`` with the kernel already flipped, on x's device and in
    x's dtype."""
    up_x, up_y = _as_pair(up)
    down_x, down_y = _as_pair(down)
    if len(pad) == 2:
        pad_x0, pad_x1, pad_y0, pad_y1 = pad[0], pad[1], pad[0], pad[1]
    else:
        pad_x0, pad_x1, pad_y0, pad_y1 = pad
    B, C, H, W = x.shape
    if up_x > 1 or up_y > 1:
        stuffed = x.new_zeros(B, C, H * up_y, W * up_x)
        stuffed[:, :, ::up_y, ::up_x] = x
        x = stuffed
    x = F.pad(x, [pad_x0, pad_x1, pad_y0, pad_y1])
    kh, kw = w.shape
    return F.conv2d(x, w.expand(C, 1, kh, kw), stride=(down_y, down_x),
                    groups=C)


def upsample2d(x: torch.Tensor, kernel: torch.Tensor,
               factor: int = 2) -> torch.Tensor:
    """StyleGAN ``Upsample``: x2 zero-stuff + gain-compensated blur."""
    p = kernel.shape[0] - factor
    return upfirdn2d(x, kernel * factor ** 2, up=factor,
                     pad=((p + 1) // 2 + factor - 1, p // 2))


def downsample2d(x: torch.Tensor, kernel: torch.Tensor,
                 factor: int = 2) -> torch.Tensor:
    """StyleGAN ``Downsample``."""
    p = kernel.shape[0] - factor
    return upfirdn2d(x, kernel, down=factor, pad=((p + 1) // 2, p // 2))


def blur(x: torch.Tensor, kernel: torch.Tensor, pad: Tuple[int, int],
         upsample_factor: int = 1) -> torch.Tensor:
    """StyleGAN ``Blur``."""
    k = kernel * upsample_factor ** 2 if upsample_factor > 1 else kernel
    return upfirdn2d(x, k, pad=pad)


def _haar_kernels():
    lo = np.ones((1, 2), dtype=np.float32) / np.sqrt(2.0)
    hi = lo.copy()
    hi[0, 0] = -hi[0, 0]
    return [torch.from_numpy(a) for a in
            (lo.T @ lo, hi.T @ lo, lo.T @ hi, hi.T @ hi)]


_HAAR_LL, _HAAR_LH, _HAAR_HL, _HAAR_HH = _haar_kernels()
# the forward's four kernels, then the inverse's negated LH and HL
_HAAR = (_HAAR_LL, _HAAR_LH, _HAAR_HL, _HAAR_HH, -_HAAR_LH, -_HAAR_HL)


def _haar_weight(x: torch.Tensor, k: int) -> torch.Tensor:
    """``_HAAR[k]`` flipped, on x's device in x's dtype."""
    return device_constant(("haar", k), x.device, x.dtype,
                           lambda: torch.flip(_HAAR[k], (0, 1)))


def haar_transform(x: torch.Tensor) -> torch.Tensor:
    """Forward Haar DWT: [B, C, H, W] -> [B, 4C, H/2, W/2], channel blocks
    ll | lh | hl | hh."""
    return torch.cat([_correlate(x, _haar_weight(x, k), 1, 2, (0, 0))
                      for k in range(4)], dim=1)


def inverse_haar_transform(x: torch.Tensor) -> torch.Tensor:
    """Inverse Haar DWT: [B, 4C, H, W] -> [B, C, 2H, 2W] (lh, hl negated)."""
    ll, lh, hl, hh = x.chunk(4, dim=1)
    pad = (1, 0, 1, 0)
    return (_correlate(ll, _haar_weight(x, 0), 2, 1, pad)
            + _correlate(lh, _haar_weight(x, 4), 2, 1, pad)
            + _correlate(hl, _haar_weight(x, 5), 2, 1, pad)
            + _correlate(hh, _haar_weight(x, 3), 2, 1, pad))
