"""Temporal feature smoothing for the face tracker.

Port of ``havatar_tpu/preprocess/tracker_features.py``: the same numpy code,
kept as its own copy so the port imports nothing of the JAX package
(tests/test_torch_tracker.py holds the two to each other exactly).

Behavioral specs (fresh implementations, oracle-tested against the reference
modules in tests/test_tracker_features.py, there for the JAX copy):

* ``Remedian`` — streaming median estimator via nested median-of-medians
  buffers (reference OpenSeeFace/remedian.py, after Rousseeuw & Bassett
  1990): values append to level 0; a full level (k=64) posts its median one
  level up and resets; a query returns the deepest non-empty level's median
  (mean-of-middle-two for even lengths).
* ``Feature`` — per-scalar normalizer/smoother (reference
  OpenSeeFace/tracker.py:150-221): tracks a running median, expanding
  min/max with hard limits that decay toward the median, maps the raw value
  into [-1, 1] around the median, then EMA-filters (alpha).
* ``FeatureExtractor`` — derives the 14 expression scalars (eye open,
  eyebrow up/down / quirk / steepness, mouth corners / open / wide) from
  the 66-point landmark set by roll-aligned point geometry (reference
  tracker.py:223-325) and runs each through its ``Feature``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np


def _median_of(values: List[float]) -> float:
    n = len(values)
    s = sorted(values)
    if n < 3:
        return s[0] if n == 1 else (s[0] + s[-1]) / 2.0
    if n % 2:
        return s[n // 2]
    return (s[n // 2] + s[n // 2 - 1]) / 2.0


class Remedian:
    """Streaming median: nested k-sized buffers of medians-of-medians."""

    def __init__(self, k: int = 64):
        self.k = k
        self.buf: List[float] = []
        self.next: Optional["Remedian"] = None

    def add(self, x: float) -> None:
        self.buf.append(float(x))
        if len(self.buf) == self.k:
            if self.next is None:
                self.next = Remedian(self.k)
            self.next.add(_median_of(self.buf))
            self.buf = []

    def median(self) -> float:
        if self.next is not None:
            return self.next.median()
        return _median_of(self.buf) if self.buf else 0.0


class Feature:
    """Median-anchored min/max normalizer with EMA smoothing
    (spec: reference tracker.py:150-221)."""

    def __init__(self, threshold: float = 0.15, alpha: float = 0.2,
                 hard_factor: float = 0.15, decay: float = 0.001,
                 max_feature_updates: float = 0):
        self.median_tracker = Remedian()
        self.min = None
        self.max = None
        self.hard_min = None
        self.hard_max = None
        self.threshold = threshold
        self.alpha = alpha
        self.hard_factor = hard_factor
        self.decay = decay
        self.last = 0.0
        self.current_median = 0.0
        self.max_feature_updates = max_feature_updates
        self.first_seen = -1.0
        self.updating = True

    def update(self, x: float, now: float = 0.0) -> float:
        if self.max_feature_updates > 0 and self.first_seen == -1:
            self.first_seen = now
        new = self._normalize(x, now)
        self.last = self.last * self.alpha + new * (1.0 - self.alpha)
        return self.last

    def _normalize(self, x: float, now: float) -> float:
        updating = self.updating and (
            self.max_feature_updates == 0
            or now - self.first_seen < self.max_feature_updates)
        if updating:
            self.median_tracker.add(x)
            self.current_median = self.median_tracker.median()
        else:
            self.updating = False
        median = self.current_median

        # expand min/max only past the calibration threshold; hard limits
        # sit hard_factor of the way back toward the median
        # the reference divides by the median unguarded (numpy float -> inf
        # on zero); replicate that semantics explicitly
        rel = lambda d: (d / median) if median != 0 else math.copysign(
            math.inf, d) if d != 0 else 0.0
        if self.min is None:
            if x < median and rel(median - x) > self.threshold:
                if updating:
                    self.min = x
                    self.hard_min = self.min + self.hard_factor * (median - self.min)
                return -1.0
            return 0.0
        elif x < self.min:
            if updating:
                self.min = x
                self.hard_min = self.min + self.hard_factor * (median - self.min)
            return -1.0
        if self.max is None:
            if x > median and rel(x - median) > self.threshold:
                if updating:
                    self.max = x
                    self.hard_max = self.max - self.hard_factor * (self.max - median)
                return 1.0
            return 0.0
        elif x > self.max:
            if updating:
                self.max = x
                self.hard_max = self.max - self.hard_factor * (self.max - median)
            return 1.0

        if updating:
            if self.min < self.hard_min:
                self.min = (self.hard_min * self.decay
                            + self.min * (1.0 - self.decay))
            if self.max > self.hard_max:
                self.max = (self.hard_max * self.decay
                            + self.max * (1.0 - self.decay))

        if x < median:
            return -(1.0 - (x - self.min) / (median - self.min))
        if x > median:
            return (x - median) / (self.max - median)
        return 0.0


def _angle(p1, p2) -> float:
    d = np.asarray(p2, np.float64) - np.asarray(p1, np.float64)
    return float(np.arctan2(d[1], d[0]) % (2.0 * np.pi))


def _rotate(origin, point, a: float):
    a = -a
    ox, oy = origin
    px, py = point
    return (ox + math.cos(a) * (px - ox) - math.sin(a) * (py - oy),
            oy + math.sin(a) * (px - ox) + math.cos(a) * (py - oy))


class FeatureExtractor:
    """66-landmark -> 14 smoothed expression features
    (spec: reference tracker.py:223-325)."""

    def __init__(self, max_feature_updates: float = 0):
        mk = lambda **kw: Feature(max_feature_updates=max_feature_updates,
                                  **kw)
        self.features: Dict[str, Feature] = {
            "eye_l": mk(), "eye_r": mk(),
            "eyebrow_updown_l": mk(), "eyebrow_updown_r": mk(),
            "eyebrow_quirk_l": mk(threshold=0.05),
            "eyebrow_quirk_r": mk(threshold=0.05),
            "eyebrow_steepness_l": mk(threshold=0.05),
            "eyebrow_steepness_r": mk(threshold=0.05),
            "mouth_corner_updown_l": mk(), "mouth_corner_updown_r": mk(),
            "mouth_corner_inout_l": mk(threshold=0.02),
            "mouth_corner_inout_r": mk(threshold=0.02),
            "mouth_open": mk(), "mouth_wide": mk(threshold=0.02),
        }

    @staticmethod
    def _align(a, b, pts):
        """Roll-compensate: rotate pts about a by the (wrapped) a->b angle."""
        alpha = _angle(tuple(a), tuple(b))
        deg = np.rad2deg(alpha)
        if deg >= 90:
            deg = -(deg - 180)
        if deg <= -90:
            deg = -(deg + 180)
        alpha = np.deg2rad(deg)
        return alpha, np.array([
            _rotate(tuple(a), tuple(p), alpha) for p in pts])

    def update(self, pts: np.ndarray, full: bool = True,
               now: float = 0.0) -> Dict[str, float]:
        """pts: [66+, 2] landmark coordinates (x, y) in any consistent frame.
        Returns the 14 smoothed features."""
        f = self.features
        out: Dict[str, float] = {}
        norm_x = float(np.mean([pts[0, 0] - pts[16, 0],
                                pts[1, 0] - pts[15, 0]]))
        norm_y = float(np.mean([pts[27, 1] - pts[28, 1],
                                pts[28, 1] - pts[29, 1],
                                pts[29, 1] - pts[30, 1]]))

        a1, p = self._align(pts[42], pts[45], pts[[43, 44, 47, 46]])
        v = abs((np.mean([p[0, 1], p[1, 1]])
                 - np.mean([p[2, 1], p[3, 1]])) / norm_y)
        out["eye_l"] = f["eye_l"].update(v, now)

        a2, p = self._align(pts[36], pts[39], pts[[37, 38, 41, 40]])
        v = abs((np.mean([p[0, 1], p[1, 1]])
                 - np.mean([p[2, 1], p[3, 1]])) / norm_y)
        out["eye_r"] = f["eye_r"].update(v, now)

        if full:
            a3, _ = self._align(pts[0], pts[16], [])
            a4, _ = self._align(pts[31], pts[35], [])
            norm_angle = float(np.mean([np.rad2deg(a)
                                        for a in (a1, a2, a3, a4)]))

            a, p = self._align(pts[22], pts[26], pts[[22, 23, 24, 25, 26]])
            out["eyebrow_steepness_l"] = f["eyebrow_steepness_l"].update(
                -np.rad2deg(a) - norm_angle, now)
            v = float(np.max(np.abs(p[1:4] - p[0, 1])) / norm_y)
            out["eyebrow_quirk_l"] = f["eyebrow_quirk_l"].update(v, now)

            a, p = self._align(pts[17], pts[21], pts[[17, 18, 19, 20, 21]])
            out["eyebrow_steepness_r"] = f["eyebrow_steepness_r"].update(
                np.rad2deg(a) - norm_angle, now)
            v = float(np.max(np.abs(p[1:4] - p[0, 1])) / norm_y)
            out["eyebrow_quirk_r"] = f["eyebrow_quirk_r"].update(v, now)
        else:
            for k in ("eyebrow_steepness_l", "eyebrow_steepness_r",
                      "eyebrow_quirk_l", "eyebrow_quirk_r"):
                out[k] = 0.0

        v = float((np.mean([pts[22, 1], pts[26, 1]]) - pts[27, 1]) / norm_y)
        out["eyebrow_updown_l"] = f["eyebrow_updown_l"].update(v, now)
        v = float((np.mean([pts[17, 1], pts[21, 1]]) - pts[27, 1]) / norm_y)
        out["eyebrow_updown_r"] = f["eyebrow_updown_r"].update(v, now)

        upper_mouth = float(np.mean([pts[49, 1], pts[50, 1], pts[51, 1]]))
        center_x = float(np.mean([pts[50, 0], pts[60, 0], pts[27, 0],
                                  pts[30, 0], pts[64, 0], pts[55, 0]]))

        out["mouth_corner_updown_l"] = f["mouth_corner_updown_l"].update(
            (upper_mouth - pts[62, 1]) / norm_y, now)
        out["mouth_corner_updown_r"] = f["mouth_corner_updown_r"].update(
            (upper_mouth - pts[58, 1]) / norm_y, now)
        if full:
            out["mouth_corner_inout_l"] = f["mouth_corner_inout_l"].update(
                abs(center_x - pts[62, 0]) / norm_x, now)
            out["mouth_corner_inout_r"] = f["mouth_corner_inout_r"].update(
                abs(center_x - pts[58, 0]) / norm_x, now)
        else:
            out["mouth_corner_inout_l"] = 0.0
            out["mouth_corner_inout_r"] = 0.0

        v = abs(float(np.mean(pts[[59, 60, 61], 1])
                      - np.mean(pts[[63, 64, 65], 1])) / norm_y)
        out["mouth_open"] = f["mouth_open"].update(v, now)
        v = abs(float(pts[58, 0] - pts[62, 0]) / norm_x)
        out["mouth_wide"] = f["mouth_wide"].update(v, now)
        return out
