"""havatar_tpu_torch.preprocess.multiview and cli.fit_video_mv against
havatar_tpu's, on the CPU.

``adjust_intrinsic`` as tests/test_data_and_preprocess.py holds JAX's, and
``make_calib``'s ``calib_{res}.json`` byte for byte. The landmark forward
through a camera transform (rotation right-multiplied by the camera's
transposed rotation, translation through it, plus the camera's) atol 1e-3
px per view, the batched forward of all views equal to the per-view one
(atol 1e-4 px). Ten iterations of the joint fit at 2 and 3 views, a first
frame (the identity and the scale fitted) and a later frame, one view
without a face: projected landmarks of the result in every view atol 1e-3
px, the last iteration's loss rtol 1e-4 (the bounds of
tests/test_torch_preprocess.py::test_ten_iteration_fit_matches_jax; the
port sums the views in one batched forward, JAX in a loop). The CLI on
tests/test_fit_video_e2e.py's synthetic FaceVerse dict, 3 views of 4
frames at 64^2 (frame 1 with a view without a face, frame 3 with none),
against JAX's CLI on the same inputs: the same files; ``calib_64.json``
byte for byte; coefficients and transforms atol 1e-4 (the fit bound of
tests/test_torch_fit_video.py); render PNGs at most 1 apart in uint8 on
at most 0.1% of the values; the split's JSON, frames sorted (both
shuffle), equal to 1e-5. A second run fits nothing.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from havatar_tpu.preprocess import faceverse as JFV
from havatar_tpu.preprocess import fitting as JFIT
from havatar_tpu.preprocess import multiview as JMV
from havatar_tpu_torch.cli import fit_video_mv
from havatar_tpu_torch.data.image_io import imread_rgb
from havatar_tpu_torch.preprocess import faceverse as TFV
from havatar_tpu_torch.preprocess import fitting as TFIT
from havatar_tpu_torch.preprocess import multiview as TMV

from test_fit_video_e2e import make_fake_faceverse
from test_torch_preprocess import _fit_model_dict, _start_state

FIT_CFG = dict(img_size=256)
COEFF_DIM = 150 + 171 + 251 + 38


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _roty(a):
    c, s = np.cos(a), np.sin(a)
    return np.asarray([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)


def _cameras(V, rng):
    """V cameras about the head: K [V, 3, 3], T [V, 4, 4]."""
    Ks, Ts = [], []
    for v in range(V):
        f = 500.0 + 20 * v
        Ks.append([[f, 0, 128 + 3 * v], [0, f + 5, 126 - 2 * v], [0, 0, 1]])
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = _roty(0.25 * (v - (V - 1) / 2))
        T[:3, 3] = rng.randn(3) * 0.1
        Ts.append(T)
    return np.asarray(Ks, np.float32), np.asarray(Ts, np.float32)


def test_adjust_intrinsic_and_calib_json(tmp_path):
    K = np.asarray([[100.0, 0, 50], [0, 100, 60], [0, 0, 1]], np.float32)
    K2 = TMV.adjust_intrinsic(K, "padding", (10, 10))
    K2 = TMV.adjust_intrinsic(K2, "crop", (20, 30))
    K2 = TMV.adjust_intrinsic(K2, "resize", (0.5, 0.5))
    np.testing.assert_allclose(K2[0, 2], (50 + 10 - 20) * 0.5)
    np.testing.assert_allclose(K2[1, 2], (60 + 10 - 30) * 0.5)
    np.testing.assert_allclose(K2[0, 0], 50.0)
    with pytest.raises(ValueError):
        TMV.adjust_intrinsic(K, "rotate", (1, 1))

    rng = np.random.RandomState(4)
    calib = {str(c): {"K": (np.eye(3) * 700 + rng.rand(3, 3)).tolist(),
                      "R": _roty(rng.randn() * 0.3).tolist(),
                      "T": (rng.randn(3) * 0.5).tolist()} for c in range(3)}
    path = str(tmp_path / "raw.json")
    json.dump(calib, open(path, "w"))
    crop = {"0": [10, 20, 900, 40], "1": [0, 5, 1024, 0],
            "2": [33, 17, 777, 12]}
    for tag, module in (("port", TMV), ("jax", JMV)):
        (tmp_path / tag).mkdir()
        module.make_calib(path, str(tmp_path / tag), crop, 512)
    got = open(tmp_path / "port" / "calib_512.json").read()
    assert got == open(tmp_path / "jax" / "calib_512.json").read()
    K0 = np.asarray(json.loads(got)["intrinsics"]["0"]["cam_K"]).reshape(3, 3)
    want = np.asarray(calib["0"]["K"], np.float32)
    np.testing.assert_allclose(K0[0, 2], (want[0, 2] + 40 - 20) * 512 / 900,
                               rtol=1e-6)


@pytest.fixture(scope="module")
def fit_models():
    md = _fit_model_dict()
    return JFV.load_model_dict(md), TFV.load_model_dict(md, device="cpu")


def _true_coeffs(rng):
    true = np.zeros((1, COEFF_DIM), np.float32)
    true[0, :150] = rng.randn(150) * 0.5
    true[0, 150:321] = np.abs(rng.randn(171)) * 0.5
    a = 150 + 171 + 251
    true[0, a:a + 3] = [0.15, -0.2, 0.05]
    true[0, a + 30:a + 33] = [0.1, -0.05, 0.2]
    true[0, a + 33:a + 37] = [0.05, -0.1, 0.02, 0.08]
    true[0, -1] = 1.05
    return true


def _jax_views(model, coeffs, Ks, Ts):
    return np.stack([np.asarray(JMV.forward_landmarks_view(
        model, jnp.asarray(coeffs), jnp.asarray(Ts[v]), Ks[v, 0, 0],
        Ks[v, 1, 1], Ks[v, 0, 2], Ks[v, 1, 2]))[0] for v in range(len(Ks))])


def test_forward_landmarks_view_matches_jax(fit_models):
    jm, tm = fit_models
    rng = np.random.RandomState(5)
    Ks, Ts = _cameras(3, rng)
    c = _true_coeffs(rng)
    want = _jax_views(jm, c, Ks, Ts)
    for v in range(3):
        got = TMV.forward_landmarks_view(tm, _t(c), _t(Ts[v]), *[
            float(x) for x in (Ks[v, 0, 0], Ks[v, 1, 1], Ks[v, 0, 2],
                               Ks[v, 1, 2])])
        assert got.shape == (1, 478, 2)
        np.testing.assert_allclose(got[0].numpy(), want[v], atol=1e-3)
    both = TMV.forward_landmarks_views(tm, _t(c), _t(Ts), _t(Ks))
    np.testing.assert_allclose(both.numpy(), want, atol=1e-3)
    for v in range(3):
        one = TMV.forward_landmarks_view(tm, _t(c), _t(Ts[v]), *[
            float(x) for x in (Ks[v, 0, 0], Ks[v, 1, 1], Ks[v, 0, 2],
                               Ks[v, 1, 2])])
        np.testing.assert_allclose(both[v].numpy(), one[0].numpy(), atol=1e-4)
    # the camera moves the landmarks
    assert np.abs(want[0] - want[2]).max() > 5.0


@pytest.mark.parametrize("V,first_frame", [(2, True), (3, False)])
def test_ten_iteration_joint_fit_matches_jax(fit_models, V, first_frame):
    jm, tm = fit_models
    rng = np.random.RandomState(6 + V)
    Ks, Ts = _cameras(V, rng)
    gt = _jax_views(jm, _true_coeffs(rng), Ks, Ts)
    gt = (gt + rng.randn(*gt.shape) * 0.5).astype(np.float32)
    valid = np.ones(V, np.float32)
    valid[1] = 0.0
    gt[1] = 0.0                       # a view without a face: zeros, as the CLI
    sj, st = _start_state(np.random.RandomState(11))
    prev = np.asarray([[0.12, -0.18, 0.04]], np.float32)
    prev_t = np.asarray([[0.1, -0.05, 0.19]], np.float32)
    fit_id = first_frame
    fj = JMV.make_fit_frame_mv(jm, Ks, Ts, JFIT.FitConfig(**FIT_CFG), 10,
                               first_frame=first_frame, fit_id=fit_id)
    ft = TMV.make_fit_frame_mv(tm, Ks, Ts, TFIT.FitConfig(**FIT_CFG), 10,
                               first_frame=first_frame, fit_id=fit_id)
    sj2, loss_j = fj(sj, jnp.asarray(gt), jnp.asarray(valid),
                     jnp.asarray(prev), jnp.asarray(prev_t))
    st2, losses = ft(st, _t(gt), _t(valid), _t(prev), _t(prev_t))
    assert losses.shape == (10,) and float(losses[-1]) < float(losses[0])
    np.testing.assert_allclose(float(losses[-1]), float(loss_j), rtol=1e-4)
    want = _jax_views(jm, np.asarray(JFIT.pack(sj2)), Ks, Ts)
    got = TMV.forward_landmarks_views(tm, TFIT.pack(st2), _t(Ts), _t(Ks))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3)
    assert float(st2.exp_c.min()) >= 0.0
    np.testing.assert_array_equal(st2.tex_c.numpy(), st.tex_c.numpy())
    if first_frame:     # the multi-view fit takes the scale with the identity
        assert float(st2.scale) != float(st.scale)
    else:
        np.testing.assert_array_equal(st2.id_c.numpy(), st.id_c.numpy())
        np.testing.assert_array_equal(st2.scale.numpy(), st.scale.numpy())


RES, VIEWS, FRAMES = 64, ("0", "1", "2"), 4


def _landmarks(rng, i, v):
    lms = np.stack([16 + 32 * rng.rand(478), 16 + 32 * rng.rand(478)],
                   -1).astype(np.float32)
    return lms + i + 2 * v


@pytest.fixture(scope="module")
def cli_inputs(tmp_path_factory):
    """Per-view frames and landmarks, a raw calibration and crop
    parameters, and the argv both CLIs take (without ``--base_dir``)."""
    import cv2

    tmp = tmp_path_factory.mktemp("fit_video_mv")
    rng = np.random.RandomState(8)
    fv_path = str(tmp / "fv.npy")
    make_fake_faceverse(fv_path)
    calib, crop = {}, {}
    for k, v in enumerate(VIEWS):
        R = _roty(0.2 * (k - 1))
        calib[v] = {"K": [[90.0 + k, 0, 40.0], [0, 91.0, 38.0 + k], [0, 0, 1]],
                    "R": R.tolist(), "T": [0.05 * k, 0.0, -0.02 * k]}
        crop[v] = [4 + k, 2, 72 + 4 * k, 6]
    calib_path = str(tmp / "calib.json")
    json.dump(calib, open(calib_path, "w"))
    lms_root = tmp / "lms"
    frames_root = tmp / "frames"
    for v in VIEWS:
        (lms_root / v).mkdir(parents=True)
        (frames_root / v).mkdir(parents=True)
        for i in range(FRAMES):
            cv2.imwrite(str(frames_root / v / f"{i}.png"),
                        (rng.rand(RES, RES, 3) * 255).astype(np.uint8))
            if (i, v) == (1, "1") or i == 3:
                continue              # no face in this view (frame 3: any)
            np.save(str(lms_root / v / f"{i}.npy"), _landmarks(rng, i, int(v)))
    argv = ["--calib_file", calib_path, "--faceverse_path", fv_path,
            "--views", *VIEWS, "--lms_root", str(lms_root), "--tar_size",
            str(RES), "--first_frame_iters", "10", "--frame_iters", "5",
            "--base_zero_frame", "1"]
    return dict(tmp=tmp, argv=argv, crop=crop, frames=str(frames_root))


def _base(cli_inputs, tag):
    base = str(cli_inputs["tmp"] / tag)
    os.makedirs(base)
    os.symlink(cli_inputs["frames"], os.path.join(base, f"mv_rgb{RES}"))
    json.dump(cli_inputs["crop"],
              open(os.path.join(base, "crop_param_mv.json"), "w"))
    return base


def _files(base):
    out = []
    for root, _, files in os.walk(os.path.join(base, "tracking")):
        out += [os.path.relpath(os.path.join(root, f), base) for f in files]
    return sorted(out)


def _close_json(got, want, path=""):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _close_json(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _close_json(g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        assert abs(got - want) <= 1e-5, (path, got, want)
    else:
        assert got == want, path


def test_cli_matches_jax_cli(cli_inputs, monkeypatch, capsys):
    from havatar_tpu.cli import fit_video_mv as jax_cli

    port, jax = _base(cli_inputs, "port"), _base(cli_inputs, "jax")
    out = fit_video_mv.main(cli_inputs["argv"] + ["--base_dir", port,
                                                  "--device", "cpu"])
    monkeypatch.setattr("sys.argv", ["fit_video_mv"] + cli_inputs["argv"]
                        + ["--base_dir", jax])
    jax_cli.main()
    printed = capsys.readouterr().out
    assert "frame 3: no valid views, skipping" in printed
    assert "WARNING! frame 1: too few faces detected" in printed
    assert out["frames"] == ["0", "1", "2"]
    assert out["valid_views"] == {"0": 3, "1": 2, "2": 3}
    assert out["last_loss"]["0"] < out["first_loss"]["0"]

    calib = f"calib_{RES}.json"
    assert (open(os.path.join(port, calib)).read()
            == open(os.path.join(jax, calib)).read())
    files = _files(port)
    assert files == _files(jax) and len(files) == 3 * 9
    for f in files:
        g, w = os.path.join(port, f), os.path.join(jax, f)
        if f.endswith("coeffs.npy"):
            np.testing.assert_allclose(np.load(g), np.load(w), atol=1e-4,
                                       err_msg=f)
        elif f.endswith(".npz"):
            with np.load(g) as zg, np.load(w) as zw:
                assert sorted(zg.files) == sorted(zw.files)
                for k in zw.files:
                    np.testing.assert_allclose(zg[k], zw[k], atol=1e-4,
                                               err_msg=f"{f}:{k}")
        elif f.endswith(".png"):
            diff = np.abs(imread_rgb(g).astype(np.int16)
                          - imread_rgb(w).astype(np.int16))
            assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, f

    split = "mv_v31_all.json"
    assert out["split"] == os.path.join(port, split)
    got = json.loads(open(out["split"]).read().replace(port, "B"))
    want = json.loads(open(os.path.join(jax, split)).read().replace(jax, "B"))
    for d in (got, want):
        d["frames"].sort(key=lambda f: f["fidx"])
    assert [f["fidx"] for f in got["frames"]] == [1, 2]
    _close_json(got, want)

    again = fit_video_mv.main(cli_inputs["argv"] + ["--base_dir", port,
                                                    "--device", "cpu"])
    assert again["frames"] == []
    capsys.readouterr()
