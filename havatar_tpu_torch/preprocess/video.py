"""Video frame extraction with a fixed face crop, and the matting driver.

Port of ``havatar_tpu/preprocess/video.py`` (host numpy and OpenCV, the
same code). Spec: extract_video_frame (fit_video.py:534-638): detect the face
once on the first frame, derive a fixed square crop (center = landmark 27,
half-size = 1.05 x brow-to-chin distance), pad with a constant border so the
crop never leaves the image, write ``mv_rgb{res}/0/{i}.png`` at
``dst_resolution`` and the crop params to ``crop_param.json`` — and
``Bg_Matting`` (fit_video.py:640-659) writing ``mv_mask{res}/0/{i}.png``.

The face detector is a pluggable 68/478-landmark backend (see landmarks.py);
the reference uses OpenSeeFace's 66-point tracker for this step only.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Optional

import numpy as np


def crop_params_from_landmarks(lms_yx: np.ndarray, border: int):
    """66-pt landmark layout (OpenSeeFace order): brow points 19/24, chin 8,
    nose bridge 27 (spec: fit_video.py:535-605)."""
    brow_avg = (lms_yx[19] + lms_yx[24]) * 0.5
    bottom = lms_yx[8]
    length = float(np.sqrt(np.sum(np.square(brow_avg - bottom)))) * 1.05
    length_in = int(length)
    center = lms_yx[27].copy().astype(np.int64) + border
    top = int(center[1] - length_in)
    left = int(center[0] - length_in)
    resolution = 2 * length_in
    return top, left, resolution, border


def crop_params_from_mediapipe(lms_xy: np.ndarray, border: int):
    """478-pt mediapipe alternative: brows 105/334, chin 152, nose bridge 6."""
    lms = np.asarray(lms_xy)
    brow_avg = (lms[105] + lms[334]) * 0.5
    bottom = lms[152]
    length = float(np.linalg.norm(brow_avg - bottom)) * 1.05
    length_in = int(length)
    center = lms[6].astype(np.int64) + border
    top = int(center[1] - length_in)
    left = int(center[0] - length_in)
    return top, left, 2 * length_in, border


def extract_video_frames(video_path: str, base_dir: str,
                         detect_fn: Callable[[np.ndarray], Optional[np.ndarray]],
                         dst_resolution: int = 512, skip: int = 1,
                         start_count: int = 0,
                         crop_fn=crop_params_from_mediapipe) -> int:
    """detect_fn: RGB frame -> [N, 2] (x, y) landmarks or None."""
    import cv2

    dst = os.path.join(base_dir, f"mv_rgb{dst_resolution}", "0")
    os.makedirs(dst, exist_ok=True)
    cap = cv2.VideoCapture(video_path)
    ok, frame = cap.read()
    if not ok:
        raise RuntimeError(f"cannot read video {video_path}")

    lms = detect_fn(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
    if lms is None:
        cv2.imwrite(os.path.join(dst, "-1.png"), frame)
        raise RuntimeError("no face detected in the first frame")

    border = min(frame.shape[:2]) // 2
    top, left, resolution, pad = crop_fn(lms, border)
    bottom, right = top + resolution, left + resolution

    def write(frame, count):
        padded = cv2.copyMakeBorder(frame, pad, pad, pad, pad,
                                    cv2.BORDER_CONSTANT, value=0)
        crop = padded[top:bottom, left:right]
        cv2.imwrite(os.path.join(dst, f"{count}.png"),
                    cv2.resize(crop, (dst_resolution, dst_resolution),
                               interpolation=cv2.INTER_LINEAR))

    write(frame, start_count)
    count = start_count
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        count += 1
        if skip > 1 and count % skip != 0:
            continue
        write(frame, count)
    cap.release()

    with open(os.path.join(base_dir, "crop_param.json"), "w") as f:
        f.write(json.dumps([int(top), int(left), int(resolution), int(pad)],
                           indent=4))
    return count


def run_matting(base_dir: str, matting_backend, dst_resolution: int = 512,
                view: str = "0") -> int:
    """Frame-serial matting over mv_rgb -> mv_mask (spec: fit_video.py:640-659)."""
    import cv2

    img_dir = os.path.join(base_dir, f"mv_rgb{dst_resolution}", view)
    mask_dir = os.path.join(base_dir, f"mv_mask{dst_resolution}", view)
    os.makedirs(mask_dir, exist_ok=True)
    names = sorted(os.listdir(img_dir), key=lambda n: int(n.split(".")[0]))
    matting_backend.reset()
    for name in names:
        frame = cv2.cvtColor(cv2.imread(os.path.join(img_dir, name)),
                             cv2.COLOR_BGR2RGB)
        if hasattr(matting_backend, "set_frame"):
            matting_backend.set_frame(name.split(".")[0])
        alpha = matting_backend.alpha(frame)
        cv2.imwrite(os.path.join(mask_dir, name),
                    (np.clip(alpha, 0, 1) * 255).astype(np.uint8))
    return len(names)
