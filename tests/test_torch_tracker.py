"""havatar_tpu_torch.preprocess.{tracker, tracker_features, headpose} and
the OpenSeeFace landmark backend against havatar_tpu's on the CPU.

* ``tracker_features``: Remedian, Feature and FeatureExtractor give JAX's
  numbers exactly on the same streams.
* ``headpose``: ``estimate``, ``normalize_pts3d`` and ``adjust`` on the same
  landmarks, with numpy's global generator seeded alike before each side
  (``adjust`` draws from it), give JAX's results exactly, frame after frame.
* The tracker's state machine (detect, track, miss, discard, re-detect)
  and its multi-face slots, with gaze, head pose and features, on injected
  numpy callables: the port's ``Tracker`` and JAX's ``JaxTracker`` return
  the same faces frame by frame.
* ``Tracker.from_weights`` on seeded weight files (landmark, detection and
  gaze nets, the confident heads of ``landmark_net.confident_heads_``)
  against ``JaxTracker.from_weights`` on the same files: landmarks within
  1e-2 px (the nets agree within 2e-5; the offsets' logit and the crop
  scale amplify it), single face and two faces.
* ``OpenSeeFaceBackend`` against ``JaxOpenSeeFaceBackend``; ``get_backend
  ("openseeface")`` without weights raises as JAX's does.
"""

import numpy as np
import pytest
import torch

from havatar_tpu.preprocess import headpose as JH
from havatar_tpu.preprocess import landmarks as JLM
from havatar_tpu.preprocess import tracker as JT
from havatar_tpu.preprocess import tracker_features as JF
from havatar_tpu_torch.preprocess import headpose as H
from havatar_tpu_torch.preprocess import landmark_net as L
from havatar_tpu_torch.preprocess import landmarks as LM
from havatar_tpu_torch.preprocess import tracker as T
from havatar_tpu_torch.preprocess import tracker_features as F

LM_ATOL_PX = 1e-2


def test_tracker_features_are_jax_s():
    rng = np.random.RandomState(0)
    ours, theirs = F.Remedian(), JF.Remedian()
    for x in rng.randn(700) * 3:
        ours.add(float(x))
        theirs.add(float(x))
        assert ours.median() == theirs.median()
    for threshold in (0.15, 0.02):
        a, b = F.Feature(threshold=threshold), JF.Feature(threshold=threshold)
        xs = np.sin(np.linspace(0, 20, 300)) + rng.randn(300) * 0.05
        xs[40], xs[150] = 3.0, -0.5
        for x in xs:
            assert a.update(float(x)) == b.update(float(x))
    base = np.stack([rng.rand(66) * 200 + 20, rng.rand(66) * 200 + 20], -1)
    a, b = F.FeatureExtractor(), JF.FeatureExtractor()
    for t in range(30):
        pts = base + np.sin(t / 3.0) * 4.0 + rng.randn(66, 2) * 0.8
        assert a.update(pts) == b.update(pts)


def _observation(rng, t, width=224, height=224):
    """The canonical face projected through a slowly turning pose."""
    import cv2

    rvec = np.array([0.1 + 0.02 * t, -0.2 + 0.05 * t, 0.05])
    tvec = np.array([0.05, -0.1, 2.5])
    camera = np.array([[width, 0, width / 2], [0, width, height / 2],
                       [0, 0, 1]], np.float64)
    proj, _ = cv2.projectPoints(H.FACE_3D[:66].astype(np.float64), rvec, tvec,
                                camera, np.zeros((4, 1)))
    lms = np.zeros((66, 3))
    lms[:, 0:2] = proj[:, 0, :] + rng.randn(66, 2) * 0.5
    lms[:, 2] = 0.6 + 0.3 * rng.rand(66)
    eye = np.array([[1.0, lms[37, 0], lms[37, 1], 0.8],
                    [1.0, lms[43, 0], lms[43, 1], 0.8]])
    return lms, eye


def test_headpose_estimate_and_adjust_are_jax_s():
    np.testing.assert_array_equal(H.FACE_3D, JH.FACE_3D)
    ours, theirs = H.HeadPoseEstimator(224, 224), JH.HeadPoseEstimator(224, 224)
    rng = np.random.RandomState(1)
    for t in range(8):
        lms, eye = _observation(rng, t)
        a = ours.estimate(lms.copy(), eye)
        b = theirs.estimate(lms.copy(), eye)
        assert a[0] == b[0]
        for x, y in zip(a[1:], b[1:]):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
        np.testing.assert_array_equal(ours.normalize_pts3d(a[4]),
                                      theirs.normalize_pts3d(b[4]))
        # euler of an upright face seen from the front: the pose gates pass
        euler = np.array([180.0, 25.0 * (t % 2), 90.0])
        np.random.seed(100 + t)
        ours.adjust(lms, 0.9, euler, float(a[3]))
        np.random.seed(100 + t)
        theirs.adjust(lms, 0.9, euler, float(b[3]))
        np.testing.assert_array_equal(ours.face_3d, theirs.face_3d)
        np.testing.assert_array_equal(ours.update_counts, theirs.update_counts)
    assert ours.update_counts.sum() > 0          # adjust did move points


# ---- the driver on injected callables ---------------------------------------

def _hm(cy, cx, conf=0.9):
    """[28, 28, 198]: 66 peaks in an 8 x 9 block at (cy, cx), offsets 0.5."""
    hm = np.full((28, 28, 198), 0.5, np.float32)
    hm[:, :, :66] = 0.05
    for i in range(66):
        hm[int(np.clip(cy + i % 8 - 4, 0, 27)),
           int(np.clip(cx + i // 8 - 4, 0, 27)), i] = conf
    return hm


class FakeNets:
    """A two-peak detector and a landmark net whose peaks and confidence
    follow the crop's brightness; ``lost`` drops the confidence."""

    def __init__(self, faces=1):
        self.faces, self.lost = faces, False

    def detect_fn(self, im):
        maps = np.zeros((56, 56, 2), np.float32)
        for k in range(self.faces):
            maps[24, 16 + 24 * k, 0] = 0.9 - 0.1 * k
            maps[24, 16 + 24 * k, 1] = 30.0 / 112.0
        mp = maps.copy()
        return maps, mp

    def lm_batch_fn(self, crops):
        out = []
        for c in crops:
            m = float(c.mean())
            out.append(_hm(10 + int(4 * np.tanh(m) + 4) % 8, 12,
                           0.1 if self.lost else 0.6 + 0.3 * np.tanh(m) ** 2))
        return np.stack(out)

    def lm_fn(self, crop):
        return self.lm_batch_fn(crop)[0]

    @staticmethod
    def gaze_fn(crops):
        maps = np.full((len(crops), 8, 8, 3), 0.5, np.float32)
        maps[:, :, :, 0] = 0.1
        maps[:, 3, 5, 0] = 0.8
        return maps


def _frames(n, W=320, Hh=240, seed=2):
    rng = np.random.RandomState(seed)
    out = []
    for t in range(n):
        f = (rng.rand(Hh, W, 3) * 60).astype(np.uint8)
        f[60 + t:180 + t, 40 + 2 * t:150 + 2 * t] = 200
        f[70:170, 180 - t:290 - t] = 120
        out.append(f)
    return out


def _same_faces(got, want, lm_atol=0.0):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.conf == pytest.approx(w.conf, abs=1e-5)
        np.testing.assert_allclose(g.lms, w.lms, atol=lm_atol, rtol=0)
        np.testing.assert_allclose(g.bbox, w.bbox, atol=lm_atol, rtol=0)
        for k in ("eye_state", "quaternion", "euler", "pts_3d"):
            a, b = getattr(g, k), getattr(w, k)
            assert (a is None) == (b is None), k
            if a is not None:
                np.testing.assert_allclose(a, b, atol=max(lm_atol, 1e-9) * 10,
                                           err_msg=k)
        assert (g.features is None) == (w.features is None)
        if g.features is not None:
            for k in g.features:
                assert g.features[k] == pytest.approx(w.features[k],
                                                      abs=max(lm_atol, 1e-9))


@pytest.mark.parametrize("faces", [1, 2])
def test_state_machine_and_slots_match_jax(faces):
    """detect -> track -> lost (misses, discard) -> re-detect, with gaze,
    pose and features, single face and two slots."""
    nets = FakeNets(faces)
    kw = dict(width=320, height=240, detect_fn=nets.detect_fn,
              lm_fn=nets.lm_fn, lm_batch_fn=nets.lm_batch_fn,
              gaze_fn=nets.gaze_fn, threshold=0.3, discard_after=2,
              bbox_growth=0.05, estimate_pose=True, extract_features=True,
              max_faces=faces)
    ours, theirs = T.Tracker(**kw), JT.JaxTracker(**kw)
    seen = []
    for t, frame in enumerate(_frames(9)):
        nets.lost = 3 <= t < 6
        np.random.seed(t)
        got = ours.predict(frame)
        np.random.seed(t)
        want = theirs.predict(frame)
        _same_faces(got, want)
        assert ours.faces == theirs.faces and ours.discard == theirs.discard
        seen.append(len(got))
    assert seen == [faces] * 3 + [0] * 3 + [faces] * 3


# ---- from_weights on seeded files -------------------------------------------

@pytest.fixture(scope="module")
def weight_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("osf")
    paths = {}
    for kind, seed in (("landmark", 3), ("detection", 4), ("gaze", 5)):
        net = L.seeded_net(kind, seed, model_type=3,
                           confident=kind != "gaze")
        paths[kind] = str(d / f"{kind}.pth")
        torch.save(net.state_dict(), paths[kind])
    return paths


@pytest.mark.parametrize("faces", [1, 2])
def test_from_weights_matches_jax(weight_files, faces):
    kw = dict(detect_weights=weight_files["detection"],
              gaze_weights=weight_files["gaze"], max_faces=faces,
              extract_features=True)
    ours = T.Tracker.from_weights(320, 240, weight_files["landmark"],
                                  device="cpu", **kw)
    theirs = JT.JaxTracker.from_weights(320, 240, weight_files["landmark"],
                                        **kw)
    n = 0
    for frame in _frames(3, seed=6):
        got, want = ours.predict(frame), theirs.predict(frame)
        _same_faces(got, want, LM_ATOL_PX)
        n += len(got)
    assert n >= 3                     # the confident heads find a face
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            T.Tracker.from_weights(320, 240, weight_files["landmark"])


def test_openseeface_backend_matches_jax(weight_files, tmp_path):
    frame = _frames(1, seed=7)[0]
    ours = LM.get_backend("openseeface", lm_weights=weight_files["landmark"],
                          device="cpu")
    assert isinstance(ours, LM.OpenSeeFaceBackend)
    theirs = JLM.JaxOpenSeeFaceBackend(weight_files["landmark"])
    got, want = ours.detect(frame), theirs.detect(frame)
    assert got.shape == (66, 2)
    np.testing.assert_allclose(got, want, atol=LM_ATOL_PX)
    ours.conf_threshold = theirs.conf_threshold = 0.99
    assert ours.detect(frame) is None and theirs.detect(frame) is None
    missing = str(tmp_path / "none.pth")
    for get in (LM.get_backend, JLM.get_backend):
        with pytest.raises(RuntimeError, match="landmark weights not found"):
            get("openseeface", lm_weights=missing)
