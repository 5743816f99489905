"""Face-landmark backends for the fitting.

Port of ``havatar_tpu/preprocess/landmarks.py``'s backends that need no
network of the repository's own. The fitting needs one [478, 2] pixel
landmark array a frame:

* ``MediapipeBackend``: MediaPipe FaceMesh (the reference's landmark
  source), imported when the backend is built;
* ``PrecomputedBackend``: ``{frame}.npy`` files written by any tracker.

The OpenSeeFace landmark network (JAX: ``JaxOpenSeeFaceBackend``) is not
ported yet (ROADMAP.md, Queue 1: the preprocessing networks).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

NETWORKS_NOT_PORTED = ("not ported yet: the preprocessing networks "
                       "(ROADMAP.md, Queue 1)")


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


def get_backend(name: str = "auto", **kwargs) -> LandmarkBackend:
    """``mediapipe``, ``precomputed`` (``lms_dir=``) or ``auto`` (MediaPipe
    if it imports, else precomputed files); ``openseeface`` raises."""
    if name == "openseeface":
        raise NotImplementedError(f"the OpenSeeFace backend is "
                                  f"{NETWORKS_NOT_PORTED}")
    if name in ("auto", "mediapipe"):
        try:
            return MediapipeBackend()
        except ImportError:
            if name == "mediapipe":
                raise
    if name in ("auto", "precomputed") and "lms_dir" in kwargs:
        return PrecomputedBackend(kwargs["lms_dir"])
    raise RuntimeError(
        "no landmark backend available: install mediapipe, or give "
        "precomputed landmarks via lms_dir=")
