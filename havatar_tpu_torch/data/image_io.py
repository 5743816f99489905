"""Image files in and out: the one place the port touches an image codec.

OpenCV does the work, imported inside the functions so that importing the
package needs no ``cv2``. Arrays are RGB, uint8, [H, W, 3].
"""

from __future__ import annotations

import numpy as np

CODEC = "cv2"


def imread_rgb(path: str) -> np.ndarray:
    """An image file as RGB uint8 [H, W, 3] (grey and alpha files are
    converted as OpenCV's default read does)."""
    import cv2

    img = cv2.imread(path)
    if img is None:
        raise FileNotFoundError(path)
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def imwrite_rgb(path: str, img: np.ndarray) -> None:
    """RGB uint8 [H, W, 3] to a file whose type its extension names."""
    import cv2

    if not cv2.imwrite(path, cv2.cvtColor(np.ascontiguousarray(img),
                                          cv2.COLOR_RGB2BGR)):
        raise OSError(f"could not write {path}")


def resize(img: np.ndarray, scale: float = 0.0, size: int = 0,
           area: bool = True) -> np.ndarray:
    """To ``size`` x ``size`` or by ``scale``; area or bilinear filter."""
    import cv2

    interp = cv2.INTER_AREA if area else cv2.INTER_LINEAR
    if size:
        return cv2.resize(img, dsize=(size, size), interpolation=interp)
    return cv2.resize(img, dsize=(0, 0), fx=scale, fy=scale,
                      interpolation=interp)
