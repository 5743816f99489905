"""Background matting backends.

Port of ``havatar_tpu/preprocess/matting.py``'s backends that need no
network of the repository's own:

* ``RVMTorchBackend``: Robust Video Matting from its TorchScript file (the
  reference's matting, fit_video.py:640-659), on the port's device;
* ``PrecomputedBackend``: existing mask PNGs;
* ``ThresholdBackend``: a colour-distance threshold against a background
  frame.

The RVM network rebuilt in the repository (JAX: ``JaxRVMBackend``) is not
ported yet (ROADMAP.md, Queue 1: the preprocessing networks).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from havatar_tpu_torch.device import DeviceLike, resolve_device


class MattingBackend:
    def reset(self) -> None:
        pass

    def alpha(self, frame_rgb: np.ndarray) -> np.ndarray:
        """[H, W, 3] uint8 -> [H, W] float alpha in [0, 1]."""
        raise NotImplementedError


class RVMTorchBackend(MattingBackend):
    """Recurrent matting, frame by frame with the recurrent state carried
    (fit_video.py:640-659)."""

    def __init__(self, torchscript_path: str, downsample_ratio: float = 0.25,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.model = torch.jit.load(torchscript_path,
                                    map_location=self.device).eval()
        self.downsample_ratio = downsample_ratio
        self.rec = [None] * 4

    def reset(self) -> None:
        self.rec = [None] * 4

    def alpha(self, frame_rgb: np.ndarray) -> np.ndarray:
        src = (torch.from_numpy(frame_rgb).to(self.device)
               .permute(2, 0, 1)[None].float() / 255.0)
        with torch.no_grad():
            fgr, pha, *self.rec = self.model(src, *self.rec,
                                             self.downsample_ratio)
        return pha[0, 0].cpu().numpy()


class PrecomputedBackend(MattingBackend):
    """Reads ``{mask_dir}/{name}.png``."""

    def __init__(self, mask_dir: str):
        self.mask_dir = mask_dir
        self._current: Optional[str] = None

    def set_frame(self, name: str) -> None:
        self._current = name

    def alpha(self, frame_rgb: np.ndarray) -> np.ndarray:
        import cv2

        path = os.path.join(self.mask_dir, f"{self._current}.png")
        m = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
        if m is None:
            raise FileNotFoundError(path)
        return m.astype(np.float32) / 255.0


class ThresholdBackend(MattingBackend):
    """Chroma distance to a background frame, thresholded."""

    def __init__(self, bg_rgb: np.ndarray, thresh: float = 30.0):
        self.bg = bg_rgb.astype(np.float32)
        self.thresh = thresh

    def alpha(self, frame_rgb: np.ndarray) -> np.ndarray:
        d = np.linalg.norm(frame_rgb.astype(np.float32) - self.bg, axis=-1)
        return (d > self.thresh).astype(np.float32)
