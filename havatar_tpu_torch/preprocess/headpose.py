"""PnP head-pose estimation + runtime 3D face adaptation for the tracker.

Port of ``havatar_tpu/preprocess/headpose.py``: the same numpy and OpenCV
code, kept as its own copy so the port imports nothing of the JAX package
(tests/test_torch_tracker.py holds the two to each other on the same
landmarks and seed).

Behavioral spec: the reference tracker's 3D stage — ``estimate_depth``
(OpenSeeFace/tracker.py:762-858: solvePnP against a canonical 70-point face,
per-landmark depth lifting, eyeball/pupil reconstruction, pnp error +
reset-on-anomaly), ``FaceInfo.normalize_pts3d`` (:383-398: roll-align on the
nose bridge, per-axis rescale to the canonical face), ``FaceInfo.adjust_3d``
(:400-477: confidence-weighted random-search refinement of the personal 3D
face with per-point update budgets), and ``matrix_to_quaternion``
(:118-137 — standard Shepperd decomposition). The coordinate pairing
follows the reference throughout: landmark rows are (y, x, conf) and the
camera matrix is built to match that ordering (:651-653).

This is a restructured implementation, not a transcription: the per-eye
reconstruction loops are vectorized over both eyes, the random-search
"loop" (whose reference run budget is 1) is straight-line code, and the
candidate-acceptance bookkeeping works on the eligible subset directly
instead of sentinel-filled 66-wide distance arrays. Numerics are preserved
exactly — every quirk that affects output is kept and marked with a
"parity:" comment (the swapped pupil interpolation weights, the f32
round-trip in the pupil lift, the RNG draw happening before the pose gates,
budget counters advancing even for points past the blend cap).

``FACE_3D`` is the reference's canonical face model (tracker.py:577-650) —
model DATA, transcribed as-is. The point-partition index lists used by the
yaw-gated adaptation (tracker.py:426-430) are likewise data: they encode
which landmarks belong to each half of the face.

Oracle tests: tests/test_headpose.py drives the reference's own methods on
stubbed objects against the JAX package's copy.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

# Canonical 70-point face (66 landmarks + 2 pupils + 2 eyeball centers);
# reference tracker.py:577-650.
FACE_3D = np.array([
    [0.4551769692672, 0.300895790030204, -0.764429433974752],
    [0.448998827123556, 0.166995837790733, -0.765143004071253],
    [0.437431554952677, 0.022655479179981, -0.739267175112735],
    [0.415033422928434, -0.088941454648772, -0.747947437846473],
    [0.389123587370091, -0.232380029794684, -0.704788385327458],
    [0.334630113904382, -0.361265387599081, -0.615587579236862],
    [0.263725112132858, -0.460009725616771, -0.491479221041573],
    [0.16241621322721, -0.558037146073869, -0.339445180872282],
    [0.0, -0.621079019321682, -0.287294770748887],
    [-0.16241621322721, -0.558037146073869, -0.339445180872282],
    [-0.263725112132858, -0.460009725616771, -0.491479221041573],
    [-0.334630113904382, -0.361265387599081, -0.615587579236862],
    [-0.389123587370091, -0.232380029794684, -0.704788385327458],
    [-0.415033422928434, -0.088941454648772, -0.747947437846473],
    [-0.437431554952677, 0.022655479179981, -0.739267175112735],
    [-0.448998827123556, 0.166995837790733, -0.765143004071253],
    [-0.4551769692672, 0.300895790030204, -0.764429433974752],
    [0.385529968662985, 0.402800553948697, -0.310031082540741],
    [0.322196658344302, 0.464439136821772, -0.250558059367669],
    [0.25409760441282, 0.46420381416882, -0.208177722146526],
    [0.186875436782135, 0.44706071961879, -0.145299823706503],
    [0.120880983543622, 0.423566314072968, -0.110757158774771],
    [-0.120880983543622, 0.423566314072968, -0.110757158774771],
    [-0.186875436782135, 0.44706071961879, -0.145299823706503],
    [-0.25409760441282, 0.46420381416882, -0.208177722146526],
    [-0.322196658344302, 0.464439136821772, -0.250558059367669],
    [-0.385529968662985, 0.402800553948697, -0.310031082540741],
    [0.0, 0.293332603215811, -0.137582088779393],
    [0.0, 0.194828701837823, -0.069158109325951],
    [0.0, 0.103844017393155, -0.009151819844964],
    [0.0, 0.0, 0.0],
    [0.080626352317973, -0.041276068128093, -0.134161035564826],
    [0.046439347377934, -0.057675223874769, -0.102990627164664],
    [0.0, -0.068753126205604, -0.090545348482397],
    [-0.046439347377934, -0.057675223874769, -0.102990627164664],
    [-0.080626352317973, -0.041276068128093, -0.134161035564826],
    [0.315905195966084, 0.298337502555443, -0.285107407636464],
    [0.275252345439353, 0.312721904921771, -0.244558251170671],
    [0.176394511553111, 0.311907184376107, -0.219205360345231],
    [0.131229723798772, 0.284447361805627, -0.234239149487417],
    [0.184124948330084, 0.260179585304867, -0.226590776513707],
    [0.279433549294448, 0.267363071770222, -0.248441437111633],
    [-0.131229723798772, 0.284447361805627, -0.234239149487417],
    [-0.176394511553111, 0.311907184376107, -0.219205360345231],
    [-0.275252345439353, 0.312721904921771, -0.244558251170671],
    [-0.315905195966084, 0.298337502555443, -0.285107407636464],
    [-0.279433549294448, 0.267363071770222, -0.248441437111633],
    [-0.184124948330084, 0.260179585304867, -0.226590776513707],
    [0.121155252430729, -0.208988660580347, -0.160606287940521],
    [0.041356305910044, -0.194484199722098, -0.096159882202821],
    [0.0, -0.205180167345702, -0.083299217789729],
    [-0.041356305910044, -0.194484199722098, -0.096159882202821],
    [-0.121155252430729, -0.208988660580347, -0.160606287940521],
    [-0.132325402795928, -0.290857984604968, -0.187067868218105],
    [-0.064137791831655, -0.325377847425684, -0.158924039726607],
    [0.0, -0.343742581679188, -0.113925986025684],
    [0.064137791831655, -0.325377847425684, -0.158924039726607],
    [0.132325402795928, -0.290857984604968, -0.187067868218105],
    [0.181481567104525, -0.243239316141725, -0.231284988892766],
    [0.083999507750469, -0.239717753728704, -0.155256465640701],
    [0.0, -0.256058040176369, -0.0950619498899],
    [-0.083999507750469, -0.239717753728704, -0.155256465640701],
    [-0.181481567104525, -0.243239316141725, -0.231284988892766],
    [-0.074036069749345, -0.250689938345682, -0.177346470406188],
    [0.0, -0.264945854681568, -0.112349967428413],
    [0.074036069749345, -0.250689938345682, -0.177346470406188],
    [0.257990002632141, 0.276080012321472, -0.219998998939991],
    [-0.257990002632141, 0.276080012321472, -0.219998998939991],
    [0.257990002632141, 0.276080012321472, -0.324570998549461],
    [-0.257990002632141, 0.276080012321472, -0.324570998549461],
], np.float32)

CONTOUR_PTS = (0, 1, 8, 15, 16, 27, 28, 29, 30, 31, 32, 33, 34, 35)

# Eye geometry: (outer, inner) landmark ids per eye, and the pupil landmark
# rows appended after the 66 face points.
EYE_CORNERS = np.array([[36, 39], [42, 45]])
PUPIL_ROWS = (66, 67)
# Eyeball center sits 0.385 · corner-distance behind the corner midpoint
# (12.5 mm eyeball radius vs a 30-35 mm palpebral width).
EYEBALL_DEPTH_RATIO = 0.385

# Yaw-gated adaptation point partitions (reference tracker.py:426-430 —
# data: which landmark ids lie on each half of the face). When the head
# yaws past the gate, only the far half's depths may adapt; the near half's
# depth perturbations are suppressed.
_DEPTH_FROZEN_WHEN_LOOKING = {
    # euler[1] < -10
    "left": [0, 1, 2, 3, 4, 5, 6, 7, 17, 18, 19, 20, 21, 31, 32,
             36, 37, 38, 39, 40, 41, 48, 49, 56, 57, 58, 59, 65],
    # euler[1] >= 20
    "right": [9, 10, 11, 12, 13, 14, 15, 16, 22, 23, 24, 25, 26, 34, 35,
              42, 43, 44, 45, 46, 47, 51, 52, 53, 54, 61, 62, 63],
}
_ADAPTABLE_WHEN_LOOKING = {
    "left": [8, 9, 10, 11, 12, 13, 14, 15, 16, 22, 23, 24, 25, 26, 27, 28,
             29, 33, 34, 35, 42, 43, 44, 45, 46, 47, 50, 51, 52, 53, 54, 55,
             60, 61, 62, 63, 64],
    "right": [0, 1, 2, 3, 4, 5, 6, 7, 8, 17, 18, 19, 20, 21, 27, 28, 29, 31,
              32, 33, 36, 37, 38, 39, 40, 41, 48, 49, 50, 55, 56, 57, 58, 59,
              60, 64, 65],
}


def matrix_to_quaternion(m: np.ndarray) -> np.ndarray:
    """Shepperd's rotation-matrix -> quaternion (branch on the largest
    diagonal combination for numerical stability; spec tracker.py:118-137)."""
    if m[2, 2] < 0:
        if m[0, 0] > m[1, 1]:
            t = 1 + m[0, 0] - m[1, 1] - m[2, 2]
            q = [t, m[0, 1] + m[1, 0], m[2, 0] + m[0, 2], m[1, 2] - m[2, 1]]
        else:
            t = 1 - m[0, 0] + m[1, 1] - m[2, 2]
            q = [m[0, 1] + m[1, 0], t, m[1, 2] + m[2, 1], m[2, 0] - m[0, 2]]
    else:
        if m[0, 0] < -m[1, 1]:
            t = 1 - m[0, 0] - m[1, 1] + m[2, 2]
            q = [m[2, 0] + m[0, 2], m[1, 2] + m[2, 1], t, m[0, 1] - m[1, 0]]
        else:
            t = 1 + m[0, 0] + m[1, 1] + m[2, 2]
            q = [m[1, 2] - m[2, 1], m[2, 0] - m[0, 2], m[0, 1] - m[1, 0], t]
    return np.asarray(q, np.float32) * 0.5 / np.sqrt(t)


class HeadPoseEstimator:
    """Per-face 3D state: solvePnP pose, per-landmark depth lifting, and the
    personal-face random-search refinement. One instance per tracked face."""

    def __init__(self, width: int, height: int):
        self.camera = np.array([[width, 0, width / 2],
                                [0, width, height / 2],
                                [0, 0, 1]], np.float32)
        self.inverse_camera = np.linalg.inv(self.camera)
        self.dist_coeffs = np.zeros((4, 1))
        self.face_3d = FACE_3D.copy()
        self.contour_pts = list(CONTOUR_PTS)
        self.contour = self.face_3d[self.contour_pts].astype(np.float64)
        self.rotation: Optional[np.ndarray] = None
        self.translation = np.array([0.0, 0.0, 0.0], np.float32)
        self.update_counts = np.zeros((66, 2))
        self.update_count_delta = 75.0
        self.update_count_max = 7500.0
        self.fail_count = 0
        self.base_scale_v = (self.face_3d[27:30, 1] - self.face_3d[28:31, 1])
        self.base_scale_h = np.abs(self.face_3d[[0, 36, 42], 0]
                                   - self.face_3d[[16, 39, 45], 0])

    def _update_contour(self):
        self.contour = np.array(self.face_3d[self.contour_pts],
                                dtype=np.float64)

    def _reset_personal_face(self):
        """Discard the adapted model after repeated anomalous fits."""
        self.face_3d = FACE_3D.copy()
        self.rotation = None
        self.translation = np.array([0.0, 0.0, 0.0], np.float32)
        self.update_counts = np.zeros((66, 2))
        self._update_contour()

    # -- geometry helpers ---------------------------------------------------

    def _solve_pose(self, image_pts: np.ndarray):
        """solvePnP on the contour points, warm-started from the previous
        frame's pose when one exists (spec tracker.py:766-776)."""
        import cv2

        if self.rotation is not None:
            rvec0, tvec0 = self.rotation.T, self.translation.T
        else:
            rvec0 = np.array([0, 0, 0], np.float32)
            tvec0 = np.array([0, 0, 0], np.float32)
        return cv2.solvePnP(
            self.contour, image_pts, self.camera, self.dist_coeffs,
            useExtrinsicGuess=True, rvec=rvec0, tvec=tvec0,
            flags=cv2.SOLVEPNP_ITERATIVE)

    def _unproject(self, pix_h: np.ndarray, inv_rmat: np.ndarray
                   ) -> np.ndarray:
        """Homogeneous pixel coords (pixel · depth, depth) -> the canonical
        face frame: undo K, the translation, then the rotation."""
        cam_pts = pix_h @ self.inverse_camera.T - self.translation
        return cam_pts @ inv_rmat.T

    def _project_depths(self, pts: np.ndarray, rmat: np.ndarray
                        ) -> np.ndarray:
        """Camera-space depth of canonical-frame points under the current
        pose, as seen through K (the z row of K is (0,0,1), so this is the
        camera z after the rigid transform)."""
        return ((pts @ rmat.T + self.translation) @ self.camera.T)[..., 2]

    # -- estimate_depth (spec tracker.py:762-858) --------------------------

    def estimate(self, lms66: np.ndarray, eye_state: np.ndarray):
        """lms66: [66, 3] rows (y, x, conf); eye_state: [2, 4] rows
        [open, y, x, conf]. Returns (success, quaternion, euler, pnp_error,
        pts_3d [70, 3], lms [70, 3])."""
        import cv2

        pupil_rows = np.asarray(eye_state, np.float64)[:, 1:4]
        lms = np.concatenate((lms66, pupil_rows), 0)

        success, rotation, translation = self._solve_pose(
            np.array(lms)[self.contour_pts, 0:2])
        pts_3d = np.zeros((70, 3), np.float32)
        if not success:
            self.rotation = np.array([0.0, 0.0, 0.0], np.float32)
            self.translation = np.array([0.0, 0.0, 0.0], np.float32)
            return False, np.zeros(4), np.zeros(3), 99999.0, pts_3d, lms
        # flat (3,) vectors: the reference relies on the OLD cv2 in-place
        # useExtrinsicGuess contract that returned the (3,) guess arrays —
        # modern cv2 returns (3, 1), which breaks its own downstream
        # broadcasting (tracker.py:833); normalizing here restores the
        # historical semantics
        self.rotation = np.asarray(rotation).reshape(3)
        self.translation = np.asarray(translation).reshape(3)

        rmat, _ = cv2.Rodrigues(rotation)
        inv_rmat = np.linalg.inv(rmat)

        # lift the 66 observed landmarks to 3D at the depths the CURRENT
        # personal face projects to under the fitted pose
        proj = (self.face_3d @ rmat.T + self.translation) @ self.camera.T
        depths = proj[:, 2].copy()
        depths[depths == 0] = 0.000001
        pix_h = np.stack([lms[0:66, 0], lms[0:66, 1], np.ones((66,))], 1)
        # parity: the reference stages pixel·depth through the f32 pts_3d
        # array before unprojecting (tracker.py:790-792) — keep the rounding
        pts_3d[0:66] = self._unproject(
            (pix_h * depths[0:66, None]).astype(np.float32), inv_rmat)

        # reprojection error over the rigid contour region (jaw + nose)
        expected = proj[:, 0:2] / depths[:, None]
        pnp_error = np.power(lms[0:17, 0:2] - expected[0:17], 2).sum()
        pnp_error += np.power(lms[30, 0:2] - expected[30], 2).sum()
        if np.isnan(pnp_error):
            pnp_error = 9999999.0

        # pupils, both eyes at once: interpolate a 3D anchor between the
        # lifted eye corners, take its projected depth, lift the observed
        # pupil pixel at that depth.
        corners_3d = pts_3d[EYE_CORNERS]                       # [2, 2, 3]
        corner_px = lms[EYE_CORNERS.reshape(-1), 0:2].reshape(2, 2, 2)
        d = np.linalg.norm(lms[PUPIL_ROWS, None, 0:2] - corner_px, axis=-1)
        # parity: the reference weights each corner by its OWN distance to
        # the pupil (tracker.py:826-830) — the outer corner pulls harder the
        # farther the pupil sits from it. Kept as-is.
        anchor = (corners_3d * d[..., None]).sum(1) / d.sum(1)[:, None]
        pup_depth = self._project_depths(anchor, rmat)
        pup_h = np.concatenate(
            [lms[PUPIL_ROWS, 0:2] * pup_depth[:, None], pup_depth[:, None]],
            1).astype(np.float32)   # parity: reference rounds through f32
        pts_3d[66:68] = self._unproject(pup_h, inv_rmat)

        # eyeball centers, both eyes at once: behind the corner midpoint
        mid = corners_3d.mean(1)
        span = np.linalg.norm(corners_3d[:, 0] - corners_3d[:, 1], axis=-1)
        offset = np.zeros((2, 3), np.float32)
        offset[:, 2] = EYEBALL_DEPTH_RATIO * span
        pts_3d[68:70] = mid - offset

        pts_3d[np.isnan(pts_3d).any(axis=1)] = np.array([0.0, 0.0, 0.0],
                                                        np.float32)

        pnp_error = np.sqrt(pnp_error / (2.0 * len(self.contour_pts)))
        if pnp_error > 300:
            self.fail_count += 1
            if self.fail_count > 5:
                self._reset_personal_face()
        else:
            self.fail_count = 0

        euler = cv2.RQDecomp3x3(rmat)[0]
        return (True, matrix_to_quaternion(rmat), euler, pnp_error, pts_3d,
                lms)

    # -- normalize_pts3d (spec tracker.py:383-398) -------------------------

    def normalize_pts3d(self, pts_3d: np.ndarray) -> np.ndarray:
        """Center on the nose tip, roll-align the nose bridge to vertical,
        and rescale each axis to the canonical face's proportions."""
        pts_3d = pts_3d.copy()
        nose_tip, bridge_top = pts_3d[30], pts_3d[27]
        pts_3d[:, 0:2] -= nose_tip[0:2]
        d = bridge_top[0:2] - nose_tip[0:2]
        alpha = float(np.arctan2(d[1], d[0]) % (2 * np.pi)) - np.deg2rad(90)
        rot2d = np.array([[np.cos(alpha), -np.sin(alpha)],
                          [np.sin(alpha), np.cos(alpha)]])
        pts_3d[:, 0:2] = ((pts_3d - pts_3d[30])[:, 0:2] @ rot2d
                          + pts_3d[30, 0:2])
        pts_3d[:, 1] /= np.mean((pts_3d[27:30, 1] - pts_3d[28:31, 1])
                                / self.base_scale_v)
        pts_3d[:, 0] /= np.mean(np.abs(pts_3d[[0, 36, 42], 0]
                                       - pts_3d[[16, 39, 45], 0])
                                / self.base_scale_h)
        return pts_3d

    # -- adjust_3d (spec tracker.py:400-477) -------------------------------

    def adjust(self, lms: np.ndarray, conf: float, euler: np.ndarray,
               pnp_error: float, static_model: bool = False,
               limit: bool = True) -> None:
        """One random-search proposal step refining the personal 3D face
        toward the observed landmarks, gated by pose and per-point update
        budgets. (The reference structures this as a loop with a run budget
        of 1, tracker.py:405 — it IS a single proposal step.)"""
        import cv2

        if conf < 0.4 or pnp_error > 300 or static_model:
            return

        # parity: the RNG draw precedes the pose gates (tracker.py:412), so
        # a gated-out frame still consumes one (66, 3) sample.
        scale = 1.0 + np.random.random_sample((66, 3)) * 0.02 - 0.01
        scale[30, :] = 1.0   # the nose tip is the anchor — never perturbed

        # pose gates: pick which axes may move and which points may adapt
        if -165 < euler[0] < 145:
            return                       # face not upright enough
        if -10 < euler[1] < 20:
            # near-frontal: adapt x/y only, symmetric budget column 0
            scale[:, 2] = 1.0
            budget_col = 0
            adaptable = np.delete(np.arange(0, 66), [30])
        else:
            # strong yaw: adapt depth only, on the far half of the face
            scale[:, 0:2] = 1.0
            if euler[2] > 120 or euler[2] < 60:
                return                   # roll out of range
            side = "left" if euler[1] < -10 else "right"
            scale[_DEPTH_FROZEN_WHEN_LOOKING[side], 2] = 1.0
            budget_col = 1
            adaptable = _ADAPTABLE_WHEN_LOOKING[side]

        if limit:
            # budget gate REPLACES the pose-derived point set (reference
            # tracker.py:433): a point may only adapt while its count in
            # this column stays within delta of the other column's count.
            other = abs(budget_col - 1)
            adaptable = np.nonzero(
                self.update_counts[:, budget_col]
                < self.update_counts[:, other] + self.update_count_delta)[0]
            if adaptable.shape[0] <= 0:
                return

        adaptable = np.asarray(adaptable)
        candidate = self.face_3d[0:66] * scale

        def reproject(pts):
            return np.squeeze(np.array(cv2.projectPoints(
                pts, self.rotation, self.translation, self.camera,
                self.dist_coeffs)[0]), 1)

        target_px = lms[adaptable, 0:2]
        base_err = np.linalg.norm(
            reproject(self.face_3d[adaptable]) - target_px, axis=1)
        cand_err = np.linalg.norm(
            reproject(candidate[adaptable]) - target_px, axis=1)
        accepted = adaptable[cand_err < base_err]
        if accepted.shape[0] == 0:
            return

        # parity: budget counters advance for every accepted point, even
        # ones already past the blend cap below (tracker.py:456).
        self.update_counts[accepted, budget_col] += 1
        if limit:
            accepted = accepted[self.update_counts[accepted, budget_col]
                                <= self.update_count_max]

        # blend accepted candidates in, weighted by landmark confidence
        # (confident points move fully; conf > 0.7 saturates to 1)
        w = np.where(lms[accepted, 2:3] > 0.7, 1.0, lms[accepted, 2:3])
        self.face_3d[accepted] = (self.face_3d[accepted] * (1.0 - w)
                                  + candidate[accepted] * w)
        self._update_contour()
