"""Face-landmark backends for the fitting.

Port of ``havatar_tpu/preprocess/landmarks.py``. The fitting needs one
[478, 2] pixel landmark array a frame:

* ``MediapipeBackend``: MediaPipe FaceMesh (the reference's landmark
  source), imported when the backend is built;
* ``PrecomputedBackend``: ``{frame}.npy`` files written by any tracker;
* ``OpenSeeFaceBackend`` (JAX: ``JaxOpenSeeFaceBackend``): OpenSeeFace's
  landmark net (preprocess/landmark_net.py) on the device, the whole frame
  as the crop; 66 (x, y) landmarks, enough for the crop and presence role
  OpenSeeFace plays in the reference (fit_video.py:534-638; pair with
  ``video.crop_params_from_landmarks``).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from havatar_tpu_torch.device import DeviceLike, resolve_device


class LandmarkBackend:
    def detect(self, frame_rgb: np.ndarray) -> Optional[np.ndarray]:
        """[H, W, 3] uint8 -> [478, 2] pixel landmarks or None (no face)."""
        raise NotImplementedError


class MediapipeBackend(LandmarkBackend):
    def __init__(self):
        import mediapipe as mp  # optional dependency

        self._mesh = mp.solutions.face_mesh.FaceMesh(
            max_num_faces=1, refine_landmarks=True,
            min_detection_confidence=0.5, min_tracking_confidence=0.5)

    def detect(self, frame_rgb: np.ndarray) -> Optional[np.ndarray]:
        res = self._mesh.process(frame_rgb)
        if not res.multi_face_landmarks:
            return None
        h, w = frame_rgb.shape[:2]
        lms = res.multi_face_landmarks[0].landmark
        return np.asarray([[p.x * w, p.y * h] for p in lms], np.float32)


class PrecomputedBackend(LandmarkBackend):
    """Reads per-frame landmark .npy files: ``{lms_dir}/{name}.npy``."""

    def __init__(self, lms_dir: str):
        self.lms_dir = lms_dir
        self._current: Optional[str] = None

    def set_frame(self, name: str) -> None:
        self._current = name

    def detect(self, frame_rgb: np.ndarray) -> Optional[np.ndarray]:
        if self._current is None:
            raise RuntimeError("call set_frame(name) first")
        path = os.path.join(self.lms_dir, f"{self._current}.npy")
        if not os.path.exists(path):
            return None
        return np.load(path).astype(np.float32)


class OpenSeeFaceBackend(LandmarkBackend):
    """OpenSeeFace's 66-point landmark net on ``device``. ``detect`` runs
    the whole frame as the crop (the reference's first, whole-frame
    detection) and returns [66, 2] (x, y) pixel landmarks, or None below
    ``conf_threshold``."""

    def __init__(self, weights_path: str, model_type: int = 3,
                 conf_threshold: float = 0.2, device: DeviceLike = None):
        from havatar_tpu_torch.preprocess import landmark_net as L

        self._L = L
        self.device = resolve_device(device)
        self.model_type = model_type
        self.conf_threshold = conf_threshold
        self.net = L.load_landmark_weights(weights_path, model_type,
                                           self.device)

    def detect(self, frame_rgb: np.ndarray) -> Optional[np.ndarray]:
        L = self._L
        h, w = frame_rgb.shape[:2]
        with torch.inference_mode():
            hm = L.nhwc(self.net(L.nchw(L.preprocess_crop(frame_rgb),
                                        self.device)))[0]
        conf, lms_yx = L.decode_landmarks(
            hm, crop_info=(0.0, 0.0, w / 224.0, h / 224.0))
        if conf < self.conf_threshold:
            return None
        return lms_yx[:, [1, 0]].astype(np.float32)  # (y,x,conf) -> (x,y)


def get_backend(name: str = "auto", **kwargs) -> LandmarkBackend:
    """``mediapipe``, ``openseeface`` (``lm_weights=``, ``model_type=``,
    ``device=``; a missing weights file raises), ``precomputed``
    (``lms_dir=``) or ``auto`` (the first of these that is available)."""
    if name in ("auto", "mediapipe"):
        try:
            return MediapipeBackend()
        except ImportError:
            if name == "mediapipe":
                raise
    if name in ("auto", "openseeface"):
        path = kwargs.get("lm_weights")
        if path and os.path.exists(path):
            return OpenSeeFaceBackend(path,
                                      model_type=kwargs.get("model_type", 3),
                                      device=kwargs.get("device"))
        if name == "openseeface":
            raise RuntimeError(f"landmark weights not found: {path}")
    if name in ("auto", "precomputed") and "lms_dir" in kwargs:
        return PrecomputedBackend(kwargs["lms_dir"])
    raise RuntimeError(
        "no landmark backend available: install mediapipe, give OpenSeeFace "
        "weights via lm_weights=, or precomputed landmarks via lms_dir=")
