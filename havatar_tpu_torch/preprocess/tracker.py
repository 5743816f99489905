"""Face tracking driver over OpenSeeFace's networks.

Port of ``havatar_tpu/preprocess/tracker.py`` (JAX: ``JaxTracker``; here
``Tracker``). Behavioural spec: ``Tracker.predict`` (reference
data_preprocessing/OpenSeeFace/tracker.py:1034-1215): detect faces with the
detection net when nothing is tracked, crop with the reference's margins
(tracker.py:1084-1087), run the landmark net, and on success carry the
landmark bounding boxes forward as the next frame's crops, re-detecting
after ``discard_after`` consecutive misses (tracker.py:1188-1204). Eye and
gaze state (get_eye_state), temporal feature smoothing
(tracker_features), PnP head pose and personal-face adaptation (headpose)
and multi-face tracking with stable slot identity are covered. Where the
reference fans crops over a thread pool of ONNX sessions
(tracker.py:1123-1166), the landmark net here runs every candidate crop in
one [F, 3, 224, 224] forward on the device.

The nets are injected as numpy-in, numpy-out callables (NHWC, the decodes'
layout), so the driver is testable without weights; ``Tracker.from_weights``
wires the port's torch nets (preprocess/landmark_net.py) on the device and
``from_onnx`` runs the reference's original .onnx blobs through
preprocess/onnx_rt.py.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

import torch

from havatar_tpu_torch.device import DeviceLike, resolve_device
from havatar_tpu_torch.preprocess import landmark_net as L


def _nhwc_fn(net, device: torch.device):
    """A net on NCHW tensors -> a numpy NHWC-in, NHWC-out callable (each
    output of a tuple converted)."""
    def run(x: np.ndarray):
        with torch.inference_mode():
            y = net(L.nchw(x, device))
        return tuple(map(L.nhwc, y)) if isinstance(y, tuple) else L.nhwc(y)
    return run


def _no_detector(im):
    """No detection net: ``_detect_faces`` then crops the whole frame."""
    return None, None


@dataclass
class FaceResult:
    """What the pipeline reads from a tracked face: ``lms`` rows are
    (y, x, conf) — the reference's layout (tracker.py:757; consumers swap to
    (x, y) themselves, fit_video.py:595)."""

    conf: float
    lms: np.ndarray                       # [66, 3] (y, x, conf)
    bbox: Tuple[float, float, float, float]  # (y1, x1, h, w) — tracker.py:1148
    success: bool = True
    # (2, 4) rows [open, eye_y, eye_x, conf] — reference tracker.py:926-991;
    # default when no gaze net is wired (tracker.py:928-929)
    eye_state: Optional[np.ndarray] = None
    # 14 smoothed expression features (tracker_features.FeatureExtractor)
    features: Optional[Dict[str, float]] = None
    # PnP head pose (preprocess/headpose.py; reference tracker.py:762-858)
    quaternion: Optional[np.ndarray] = None
    euler: Optional[np.ndarray] = None
    rotation: Optional[np.ndarray] = None
    translation: Optional[np.ndarray] = None
    pnp_error: Optional[float] = None
    pts_3d: Optional[np.ndarray] = None        # [70, 3] lifted landmarks
    eye_blink: Optional[list] = None


def _clamp_to_im(x: float, y: float, w: int, h: int) -> Tuple[int, int]:
    """spec: tracker.py clamp_to_im — clamp a point into the image."""
    return int(min(max(x, 0), w - 1)), int(min(max(y, 0), h - 1))


def _intersects(r1, r2, amount: float = 0.3) -> bool:
    """Overlap-fraction test for crop-group merging
    (spec: tracker.py:56-80 — intersection / (union) >= amount)."""
    x1, y1, w1, h1 = r1
    x2, y2, w2, h2 = r2
    left, right = max(x1, x2), min(x1 + w1, x2 + w2)
    top, bottom = max(y1, y2), min(y1 + h1, y2 + h2)
    total = w1 * h1 + w2 * h2
    inter = 0.0
    if left < right and top < bottom:
        inter = (right - left) * (bottom - top)
        total -= inter
    return total > 0 and inter / total >= amount


def _group_rects(rects) -> Dict[int, int]:
    """index -> group id; overlapping rects share a group
    (spec: tracker.py:85-104)."""
    groups = {}
    gid = 0
    for i, rect in enumerate(rects):
        if i not in groups:
            groups[i] = gid
            gid += 1
        for j, other in enumerate(rects):
            if i != j and _intersects(rect, other):
                groups[j] = groups[i]
    return groups


# ---------------------------------------------------------------------------
# Eye/gaze extraction (spec: reference tracker.py:873-991): crop a roll-
# compensated box around each eye's corner landmarks, run the 32² gaze net
# on both crops, decode the 8² heatmap peak + logit offsets, and map the
# pupil back through flip -> scale -> rotation -> face/frame offsets.
# ---------------------------------------------------------------------------

_DEFAULT_EYE = np.array([[1.0, 0.0, 0.0, 0.0], [1.0, 0.0, 0.0, 0.0]],
                        np.float32)


def _rotate_pt(origin, point, a: float):
    a = -a
    ox, oy = origin
    px, py = point
    return (ox + math.cos(a) * (px - ox) - math.sin(a) * (py - oy),
            oy + math.sin(a) * (px - ox) + math.cos(a) * (py - oy))


def _angle(p1, p2) -> float:
    d = np.asarray(p2, np.float64) - np.asarray(p1, np.float64)
    return float(np.arctan2(d[1], d[0]) % (2.0 * math.pi))


def _logit(p: float, factor: float) -> float:
    p = min(max(float(p), 1e-7), 1.0 - 1e-7)
    return math.log(p / (1.0 - p)) / factor


def _extract_face(frame_rgb: np.ndarray, lms_yx: np.ndarray):
    """Tight 1.2x-margin face crop; returns (crop, local (x,y) lms, offset)
    (spec: tracker.py:910-924)."""
    xy = np.asarray(lms_yx)[:, 0:2][:, ::-1]
    lo, hi = xy.min(0), xy.max(0)
    radius = 1.2 * (hi - lo) / 2.0
    center = (lo + hi) / 2.0
    H, W = frame_rgb.shape[:2]
    x1, y1 = _clamp_to_im(*(center - radius), W, H)
    x2, y2 = _clamp_to_im(*(center + radius + 1), W, H)
    offset = np.array((x1, y1))
    local = (xy - offset).astype(np.int64)
    return frame_rgb[y1:y2, x1:x2], local, offset


def _corners_to_eye(c1, c2, w: int, h: int):
    """Roll-compensated eye box from the two corner landmarks
    (spec: tracker.py:873-884)."""
    a = _angle(c1, c2)
    c2r = np.array(_rotate_pt(tuple(c1), tuple(c2), a))
    center = (np.asarray(c1, np.float64) + c2r) / 2.0
    r = np.linalg.norm(np.asarray(c1, np.float64) - c2r) / 2.0
    radius = np.array([r * 1.4, r * 1.2])
    x1, y1 = _clamp_to_im(*(center - radius), w, h)
    x2, y2 = _clamp_to_im(*(center + radius), w, h)
    return (x1, y1), (x2, y2), np.asarray(c1, np.float64), a


def _prepare_eye(face_rgb: np.ndarray, corners_xy: np.ndarray, flip: bool):
    """One eye -> (normalized [32, 32, 3] crop with x/y axes SWAPPED — the
    reference feeds NCWH, tracker.py:908 — plus un-mapping params)
    (spec: tracker.py:886-909)."""
    import cv2

    h, w = face_rgb.shape[:2]
    (x1, y1), (x2, y2), ref, a = _corners_to_eye(
        corners_xy[0], corners_xy[1], w, h)
    M = cv2.getRotationMatrix2D((float(ref[0]), float(ref[1])),
                                np.rad2deg(a), 1.0)
    im = cv2.warpAffine(face_rgb, M, (w, h))[int(y1):int(y2), int(x1):int(x2)]
    if np.prod(im.shape) < 1:
        return None, None, None, None, None
    if flip:
        im = cv2.flip(im, 1)
    scale = np.array([(x2 - x1), (y2 - y1)]) / 32.0
    im = L.preprocess_crop(im, res=32)[0]
    return im.transpose(1, 0, 2), (x1, y1), scale, ref, a


def get_eye_state(frame_rgb: np.ndarray, lms_yx: np.ndarray,
                  gaze_fn: Callable[[np.ndarray], np.ndarray]) -> np.ndarray:
    """[H, W, 3] RGB + 66-pt (y, x, conf) landmarks -> (2, 4) eye states
    [open, pupil_y, pupil_x, conf] in frame pixels (right eye first)
    (spec: tracker.py:926-991; ``open`` is pinned to 1.0 as in the
    reference, :950-951)."""
    face, local, offset = _extract_face(frame_rgb, lms_yx)
    right = _prepare_eye(face, local[[36, 39]].astype(np.float64), False)
    left = _prepare_eye(face, local[[42, 45]].astype(np.float64), True)
    if right[0] is None or left[0] is None:
        return _DEFAULT_EYE.copy()
    both = np.stack([right[0], left[0]])
    maps = np.asarray(gaze_fn(both))                    # [2, 8, 8, 3]

    out = []
    for i, (im, exy, scale, ref, a) in enumerate((right, left)):
        conf_map = maps[i, :, :, 0]
        m = int(conf_map.argmax())
        gx, gy = m // 8, m % 8
        conf = float(conf_map[gx, gy])
        off_x = 32.0 * _logit(maps[i, gx, gy, 1], 8.0)
        off_y = 32.0 * _logit(maps[i, gx, gy, 2], 8.0)
        eye_x = 32.0 * gx / 8.0 + off_x
        eye_y = 32.0 * gy / 8.0 + off_y
        if i == 1:   # the left crop was mirrored before the net
            eye_x = 32.0 - eye_x
        eye_x = exy[0] + scale[0] * eye_x
        eye_y = exy[1] + scale[1] * eye_y
        eye_x, eye_y = _rotate_pt(ref, (eye_x, eye_y), -a)
        out.append([1.0, eye_y + offset[1], eye_x + offset[0], conf])

    out = np.array(out, np.float32)
    out[np.isnan(out).any(axis=1)] = _DEFAULT_EYE[0]
    return out


@dataclass
class _FaceSlot:
    """Persistent per-face state: slot identity survives across frames via
    nearest-centroid matching (spec: FaceInfo, tracker.py:328+)."""

    coord: Optional[np.ndarray] = None
    features: Optional[object] = None     # FeatureExtractor
    pose: Optional[object] = None         # HeadPoseEstimator


@dataclass
class Tracker:
    """The tracker (JAX: ``JaxTracker``). detect_fn: [224,224,3] RGB float
    (normalized) -> ([56,56,2] maps, [56,56,2] maxpool). lm_fn:
    [1,224,224,3] normalized crop -> [28,28,198] heatmaps. Both
    numpy-in/numpy-out, NHWC."""

    width: int
    height: int
    detect_fn: Callable[[np.ndarray], Tuple[np.ndarray, np.ndarray]]
    lm_fn: Callable[[np.ndarray], np.ndarray]
    # None accepts any confidence (the pipeline passes threshold=None,
    # fit_video.py:585 — "no gating"; the reference would compare a float
    # against None, a py2 leftover)
    threshold: Optional[float] = None
    detection_threshold: float = 0.6
    discard_after: int = 5
    bbox_growth: float = 0.0
    model_type: int = 3
    # optional eye/gaze net ([2, 32, 32, 3] swapped-axis crops -> [2, 8, 8,
    # 3] maps) and temporal feature smoothing (tracker_features)
    gaze_fn: Optional[Callable[[np.ndarray], np.ndarray]] = None
    extract_features: bool = False
    # PnP head pose + personal-face adaptation (preprocess/headpose.py);
    # with extract_features, features then come from the normalized lifted
    # 3D points as in the reference (tracker.py:477-485)
    estimate_pose: bool = False
    static_model: bool = False
    # multi-face tracking (spec: tracker.py:1034-1215). The reference fans
    # crops over a thread pool of ONNX sessions; here the landmark net runs
    # every crop in one batched forward. Faces keep stable slot ids via nearest-
    # centroid matching (assign_face_info, tracker.py:992-1032); when a
    # slot count is below max_faces the detector re-scans every
    # ``scan_every`` frames (tracker.py:1060-1071).
    max_faces: int = 1
    scan_every: int = 3
    # optional [F, 224, 224, 3] -> [F, 28, 28, 198] batched landmark net
    # (any F: no padding of the batch); falls back to looping lm_fn when
    # absent
    lm_batch_fn: Optional[Callable[[np.ndarray], np.ndarray]] = None

    faces: List[Tuple[float, float, float, float]] = field(default_factory=list)
    discard: int = 0
    frame_count: int = 0
    wait_count: int = 0
    _slots: Optional[list] = None

    def _slot(self, i: int):
        if self._slots is None:
            self._slots = [_FaceSlot() for _ in range(self.max_faces)]
        return self._slots[i]

    @classmethod
    def from_weights(cls, width: int, height: int, lm_weights: str,
                     detect_weights: Optional[str] = None,
                     gaze_weights: Optional[str] = None,
                     model_type: int = 3, device: DeviceLike = None,
                     **kw) -> "Tracker":
        """The port's nets on ``device`` from the reference's weight files
        (``lm_model{N}.pth`` or an .npz of it, ``detection.pth``, the gaze
        net's). Without ``detect_weights`` the tracker crops the whole frame
        (JAX's ``from_weights`` does the same)."""
        dev = resolve_device(device)
        lm_batch_fn = _nhwc_fn(
            L.load_landmark_weights(lm_weights, model_type, dev), dev)
        kw.setdefault("lm_batch_fn", lm_batch_fn)
        if gaze_weights is not None:
            kw.setdefault("gaze_fn", _nhwc_fn(
                L.load_gaze_weights(gaze_weights, dev), dev))
        detect_fn = _no_detector
        if detect_weights is not None:
            det = _nhwc_fn(L.load_detection_weights(detect_weights, dev), dev)

            def detect_fn(im):
                maps, mp = det(im[None])
                return maps[0], mp[0]

        return cls(width=width, height=height, detect_fn=detect_fn,
                   lm_fn=lambda crop: lm_batch_fn(crop)[0],
                   model_type=model_type, **kw)

    @classmethod
    def from_onnx(cls, width: int, height: int, models_dir: str,
                  model_type: int = 0, use_gaze: bool = True,
                  device: DeviceLike = None, **kw) -> "Tracker":
        """The reference's original .onnx blobs (OpenSeeFace/models) run by
        preprocess/onnx_rt.py on ``device``: weight-exact with the reference
        tracker, no onnxruntime. The blobs take and give NCHW, as the port's
        nets do."""
        import os

        from havatar_tpu_torch.preprocess.onnx_rt import OnnxModel

        dev = resolve_device(device)
        lm_batch_fn = _nhwc_fn(OnnxModel(os.path.join(
            models_dir, f"lm_model{model_type}_opt.onnx"), dev), dev)
        kw.setdefault("lm_batch_fn", lm_batch_fn)
        detect_fn = _no_detector
        det_path = os.path.join(models_dir, "mnv3_detection_opt.onnx")
        if os.path.exists(det_path):
            det = _nhwc_fn(OnnxModel(det_path, dev), dev)

            def detect_fn(im):
                maps, mp = det(im[None])
                return maps[0], mp[0]

        gaze_path = os.path.join(models_dir, "mnv3_gaze32_split_opt.onnx")
        if use_gaze and os.path.exists(gaze_path):
            gz = OnnxModel(gaze_path, dev)
            # the blob has several outputs; the first is the gaze maps
            kw.setdefault("gaze_fn", _nhwc_fn(lambda x: gz(x)[0], dev))
        return cls(width=width, height=height, detect_fn=detect_fn,
                   lm_fn=lambda crop: lm_batch_fn(crop)[0],
                   model_type=model_type, **kw)

    # ---- internals --------------------------------------------------------

    def _detect_faces(self, frame_rgb: np.ndarray,
                      max_faces: int = 1) -> np.ndarray:
        """Run the 224² detection net; (x, y, w, h) boxes in frame pixels
        (spec: tracker.py:705-729). Falls back to a whole-frame box when no
        detector is wired (the landmark net's conf then gates it)."""
        im = L.preprocess_crop(frame_rgb, res=224)[0]
        maps, mp = self.detect_fn(im)
        if maps is None:
            return np.array(
                [[0.0, 0.0, self.width, self.height]], np.float32)
        return L.decode_detections(
            maps, mp, (self.height, self.width), max_faces=max_faces,
            threshold=self.detection_threshold)

    def _crop_region(self, box) -> Optional[Tuple[int, int, int, int]]:
        """Expand a face box by the reference margins (tracker.py:1084-1091)
        and clamp; None if degenerate."""
        x, y, w, h = box
        x1 = x - int(w * 0.1)
        y1 = y - int(h * 0.125)
        x2 = x + w + int(w * 0.1)
        y2 = y + h + int(h * 0.125)
        x1, y1 = _clamp_to_im(x1, y1, self.width, self.height)
        x2, y2 = _clamp_to_im(x2, y2, self.width, self.height)
        if x2 - x1 < 4 or y2 - y1 < 4:
            return None
        return x1, y1, x2, y2

    def _decode_crop_batch(self, frame_rgb, regions):
        """Run the landmark net over all candidate crops at once and decode.
        Returns [(conf, lms, region), ...]."""
        crops = np.concatenate(
            [L.preprocess_crop(frame_rgb[y1:y2, x1:x2], res=224)
             for (x1, y1, x2, y2) in regions], axis=0)
        if self.lm_batch_fn is not None:
            hms = np.asarray(self.lm_batch_fn(crops))
        else:
            hms = np.stack([self.lm_fn(crops[i:i + 1])
                            for i in range(crops.shape[0])])
        out = []
        for hm, (x1, y1, x2, y2) in zip(hms, regions):
            conf, lms = L.decode_landmarks(
                hm, crop_info=(x1, y1, (x2 - x1) / 224.0,
                               (y2 - y1) / 224.0))
            out.append((conf, lms, (x1, y1, x2, y2)))
        return out

    def _attach_extras(self, frame_rgb, face: FaceResult, slot) -> None:
        """Eye state, head pose, and smoothed features for one face, using
        the given slot's persistent state."""
        if self.gaze_fn is not None:
            face.eye_state = get_eye_state(frame_rgb, face.lms, self.gaze_fn)
        if self.estimate_pose:
            from havatar_tpu_torch.preprocess.headpose import HeadPoseEstimator

            if slot.pose is None:
                slot.pose = HeadPoseEstimator(self.width, self.height)
            es = (face.eye_state if face.eye_state is not None
                  else _DEFAULT_EYE)
            ok, quat, euler, err, pts_3d, _ = slot.pose.estimate(
                face.lms[:66].astype(np.float64), es)
            if ok:
                face.quaternion, face.euler = quat, np.asarray(euler)
                face.pnp_error = float(err)
                face.rotation = slot.pose.rotation
                face.translation = slot.pose.translation
                slot.pose.adjust(face.lms[:66], face.conf, face.euler,
                                 face.pnp_error,
                                 static_model=self.static_model)
                face.pts_3d = slot.pose.normalize_pts3d(pts_3d)
        if self.extract_features:
            from havatar_tpu_torch.preprocess.tracker_features import (
                FeatureExtractor,
            )

            if slot.features is None:
                slot.features = FeatureExtractor()
            if face.pts_3d is not None:
                feats = slot.features.update(face.pts_3d[:, 0:2])
                face.eye_blink = [1 - min(max(0, -feats["eye_r"]), 1),
                                  1 - min(max(0, -feats["eye_l"]), 1)]
            else:
                feats = slot.features.update(face.lms[:66, 0:2][:, ::-1])
            face.features = feats

    # ---- main API ---------------------------------------------------------

    def predict(self, frame_rgb: np.ndarray) -> List[FaceResult]:
        """[H, W, 3] uint8 RGB -> tracked faces (up to max_faces)."""
        if self.max_faces > 1:
            return self._predict_multi(frame_rgb)
        self.frame_count += 1
        candidates = list(self.faces)
        if not candidates:
            candidates = [tuple(b) for b in self._detect_faces(frame_rgb)]

        best: Optional[FaceResult] = None
        for box in candidates:
            region = self._crop_region(box)
            if region is None:
                continue
            x1, y1, x2, y2 = region
            crop = L.preprocess_crop(frame_rgb[y1:y2, x1:x2], res=224)
            hm = self.lm_fn(crop)
            conf, lms = L.decode_landmarks(
                hm, crop_info=(x1, y1, (x2 - x1) / 224.0, (y2 - y1) / 224.0))
            if self.threshold is not None and conf <= self.threshold:
                continue
            if best is None or conf > best.conf:
                # landmark-extent bbox carried to the next frame
                # (tracker.py:1144-1149)
                ymin, xmin = lms[:66, 0].min(), lms[:66, 1].min()
                ymax, xmax = lms[:66, 0].max(), lms[:66, 1].max()
                best = FaceResult(conf=float(conf), lms=lms,
                                  bbox=(ymin, xmin, ymax - ymin, xmax - xmin))

        if best is not None:
            y1b, x1b, hb, wb = best.bbox
            self.faces = [(x1b, y1b, wb, hb)]
            self.discard = 0
            self._attach_extras(frame_rgb, best, self._slot(0))
            return [best]

        # miss: keep (optionally grown) box for a few frames, then re-detect
        # (tracker.py:1188-1204)
        self.discard += 1
        if self.discard > self.discard_after:
            self.faces = []
        elif self.bbox_growth > 0 and self.faces:
            x, y, w, h = self.faces[0]
            g = self.bbox_growth
            self.faces = [(x - w * g, y - h * g,
                           w + 2 * w * g, h + 2 * h * g)]
        return []

    # ---- multi-face path (spec: tracker.py:1034-1215) ---------------------

    def _predict_multi(self, frame_rgb: np.ndarray) -> List[FaceResult]:
        self.frame_count += 1
        self.wait_count += 1
        detected = len(self.faces)
        candidates = [(tuple(b), 0.1) for b in self.faces]   # tracked bonus
        if detected == 0:
            candidates += [(tuple(b), 0.0)
                           for b in self._detect_faces(frame_rgb,
                                                       self.max_faces)]
            self.wait_count = 0
        elif detected < self.max_faces and self.wait_count >= self.scan_every:
            candidates += [(tuple(b), 0.0)
                           for b in self._detect_faces(frame_rgb,
                                                       self.max_faces)]
            self.wait_count = 0

        regions, bonuses = [], []
        for box, bonus in candidates:
            region = self._crop_region(box)
            if region is not None:
                regions.append(region)
                bonuses.append(bonus)
        if not regions:
            self._register_miss()
            return []

        decoded = self._decode_crop_batch(frame_rgb, regions)

        # landmark-extent bboxes (x, y, w, h) -> overlap groups -> best
        # (conf + tracked-bonus) per group (tracker.py:1144-1167)
        entries = []
        for (conf, lms, region), bonus in zip(decoded, bonuses):
            if self.threshold is not None and conf <= self.threshold:
                continue
            ymin, xmin = lms[:66, 0].min(), lms[:66, 1].min()
            ymax, xmax = lms[:66, 0].max(), lms[:66, 1].max()
            bb = (xmin, ymin, xmax - xmin, ymax - ymin)
            entries.append({"conf": conf, "lms": lms, "bb": bb,
                            "bonus": bonus})
        if not entries:
            self._register_miss()
            return []
        groups = _group_rects([e["bb"] for e in entries])
        best_per_group: Dict[int, dict] = {}
        for i, e in enumerate(entries):
            g = groups[i]
            cur = best_per_group.get(g)
            if cur is None or cur["conf"] + cur["bonus"] < e["conf"] + e["bonus"]:
                best_per_group[g] = e
        winners = sorted(best_per_group.values(),
                         key=lambda e: e["conf"] + e["bonus"],
                         reverse=True)[: self.max_faces]

        # nearest-centroid slot assignment (assign_face_info,
        # tracker.py:992-1032): greedy over (distance, slot, result)
        coords = [e["lms"][:66, 0:2].mean(0) for e in winners]
        max_dist = 2 * np.linalg.norm([self.width, self.height])
        pairs = []
        for si in range(self.max_faces):
            slot = self._slot(si)
            for ri, c in enumerate(coords):
                d = (max_dist if slot.coord is None
                     else float(np.linalg.norm(slot.coord - c)))
                pairs.append((d, si, ri))
        pairs.sort()
        used_slots, used_results = set(), set()
        assign = {}
        for d, si, ri in pairs:
            if si in used_slots or ri in used_results:
                continue
            assign[ri] = si
            used_slots.add(si)
            used_results.add(ri)

        results = []
        new_boxes = []
        for ri, e in enumerate(winners):
            si = assign[ri]
            slot = self._slot(si)
            slot.coord = coords[ri]
            lms = e["lms"]
            ymin, xmin = lms[:66, 0].min(), lms[:66, 1].min()
            ymax, xmax = lms[:66, 0].max(), lms[:66, 1].max()
            face = FaceResult(conf=float(e["conf"]), lms=lms,
                              bbox=(ymin, xmin, ymax - ymin, xmax - xmin))
            self._attach_extras(frame_rgb, face, slot)
            results.append((si, face))
            new_boxes.append((xmin, ymin, xmax - xmin, ymax - ymin))

        if new_boxes:
            self.faces = new_boxes
            self.discard = 0
        else:
            self._register_miss()
        # stable order: by slot id (the reference sorts by face_info.id)
        return [f for _, f in sorted(results, key=lambda p: p[0])]

    def _register_miss(self) -> None:
        self.discard += 1
        if self.discard > self.discard_after:
            self.faces = []
        elif self.bbox_growth > 0:
            g = self.bbox_growth
            self.faces = [(x - w * g, y - h * g, w + 2 * w * g,
                           h + 2 * h * g) for (x, y, w, h) in self.faces]
