"""havatar_tpu_torch.cli.fit_video end to end on the CPU, against the JAX
package's fitting and pipeline functions called directly.

A 12-frame 64^2 video (MJPG), tests/test_fit_video_e2e.py's synthetic
FaceVerse dict, precomputed landmarks and masks; the CLI fits frame 0 (10
iterations, the identity fitted), frames 1-9 (5, the identity fitted) and
10-11 (5, without), renders each frame's three ortho conditions and writes
the split. The same landmarks go through havatar_tpu's ``make_fit_frame``
in the CLI's order: coefficients atol 1e-4 frame by frame, each fit's last
loss rtol 1e-4; frame 0's front render against havatar_tpu's
``render_ortho_condition`` on the JAX coefficients (uint8, at most one
level apart); the split's frames against havatar_tpu's ``make_transform``
on the JAX fits (atol 1e-4), and an item of it loads through the port's
``AvatarDataset`` with finite rays. Under the flags of the repository's
networks (``--lm_weights``, ``--detect_weights``, ``--rvm_path --rvm_jax``)
on seeded weight files, a 3-frame video goes through the port's CLI and
havatar_tpu's: the same crop and frames, the masks at most one level
apart. Without ``--device`` on a host with no CUDA the CLI raises.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from havatar_tpu.preprocess import faceverse as JFV
from havatar_tpu.preprocess import fitting as JFIT
from havatar_tpu.preprocess import pipeline as JP
from havatar_tpu.preprocess.rasterizer import render_ortho_condition
from havatar_tpu_torch.cli import fit_video
from havatar_tpu_torch.data.dataset import AvatarDataset
from havatar_tpu_torch.preprocess import landmark_net as L
from havatar_tpu_torch.preprocess import rvm as RVM
from havatar_tpu_torch.utils.cfgnode import CfgNode

from test_fit_video_e2e import make_fake_faceverse

RES, N_FRAMES, FIRST_ITERS, ITERS = 64, 12, 10, 5


def _landmarks(rng, i):
    """478 landmarks in a face square that drifts a pixel a frame; the crop
    reads 105/334 (brows), 152 (chin) and 6 (bridge)."""
    lms = np.stack([16 + 32 * rng.rand(478), 16 + 32 * rng.rand(478)],
                   -1).astype(np.float32)
    lms[105], lms[334], lms[152], lms[6] = [24, 22], [40, 22], [32, 45], [32, 30]
    return lms + i


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    import cv2

    tmp = tmp_path_factory.mktemp("fit_video")
    rng = np.random.RandomState(1)
    video = str(tmp / "input.avi")
    vw = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"MJPG"), 10,
                         (RES, RES))
    assert vw.isOpened(), "OpenCV's MJPG writer did not open"
    for _ in range(N_FRAMES):
        frame = (rng.rand(RES, RES, 3) * 60).astype(np.uint8)
        frame[16:48, 16:48] = 200
        vw.write(frame)
    vw.release()
    lms_dir = tmp / "lms"
    lms_dir.mkdir()
    lms = [_landmarks(rng, i) for i in range(N_FRAMES)]
    for i, a in enumerate(lms):
        np.save(lms_dir / f"{i}.npy", a)
    fv_path = str(tmp / "faceverse_tiny.npy")
    make_fake_faceverse(fv_path)
    base = str(tmp / "out")
    mask_dir = os.path.join(base, f"mv_mask{RES}", "0")
    os.makedirs(mask_dir)
    for i in range(N_FRAMES):
        m = np.zeros((RES, RES), np.uint8)
        m[8:-8, 8:-8] = 255
        cv2.imwrite(os.path.join(mask_dir, f"{i}.png"), m)
    argv = ["--video_path", video, "--base_dir", base,
            "--faceverse_path", fv_path, "--exp52_path", str(tmp / "none"),
            "--lms_dir", str(lms_dir), "--tar_size", str(RES),
            "--first_frame_iters", str(FIRST_ITERS),
            "--frame_iters", str(ITERS), "--base_zero_frame", "10"]
    out = fit_video.main(argv + ["--device", "cpu"])
    return dict(tmp=tmp, base=base, argv=argv, out=out, lms=lms,
                fv_path=fv_path)


@pytest.fixture(scope="module")
def jax_fits(run):
    """The CLI's fitting loop on havatar_tpu's functions: the model and, per
    frame, (coeffs, loss, head_T, extr)."""
    md = np.load(run["fv_path"], allow_pickle=True).item()
    model = JFV.load_model_dict(md)
    intr = np.asarray([1315.0, 1315.0, RES / 2, RES / 2], np.float32)
    cfg = JFIT.FitConfig(img_size=RES)
    fits = [JFIT.make_fit_frame(model, intr, cfg, FIRST_ITERS, True, True),
            JFIT.make_fit_frame(model, intr, cfg, ITERS, False, True),
            JFIT.make_fit_frame(model, intr, cfg, ITERS, False, False)]
    state = JFIT.init_fit_state(model.exp_dims)
    prev_rot = prev_trans = jnp.zeros((1, 3))
    out = []
    for i in range(N_FRAMES):
        fit = fits[0 if i == 0 else 1 if i < 10 else 2]
        state, loss = fit(state, jnp.asarray(run["lms"][i]), prev_rot,
                          prev_trans)
        prev_rot, prev_trans = state.rot, state.trans
        out.append((np.asarray(JFIT.pack(state))[0], float(loss),
                    np.asarray(JFIT.head_transform_matrix(state, True)),
                    np.asarray(JFIT.head_transform_matrix(state, False))))
    return model, out


def test_cli_matches_jax_fitting_and_renders(run, jax_fits):
    import cv2

    out = run["out"]
    assert out["frames"] == [str(i) for i in range(N_FRAMES)]
    model, want = jax_fits
    save = os.path.join(run["base"], "tracking")
    for i, (coeffs, loss, _, _) in enumerate(want):
        got = np.load(os.path.join(save, str(i), "coeffs.npy"))
        np.testing.assert_allclose(got, coeffs, atol=1e-4, err_msg=str(i))
        np.testing.assert_allclose(out["last_loss"][str(i)], loss, rtol=1e-4)
        assert os.path.exists(os.path.join(save, str(i), "finish"))
        for view in ("front", "left", "right"):
            for kind in ("render", "normal"):
                assert os.path.exists(os.path.join(
                    save, str(i), f"ortho_{view}_{kind}_256_baseGama.png"))
    assert out["last_loss"]["0"] < out["first_loss"]["0"]

    c = jnp.asarray(want[0][0])[None]
    id_c, exp_c, tex_c, _, _, _, eye_c, _ = JFV.split_coeffs(c, model.exp_dims)
    verts = JP.BoxWarp(*JP.get_box_warp_param(*JP.CANONICAL_BOUNDS))(
        JFV.get_vs(model, id_c, exp_c, eye_c)[0])
    img, _ = render_ortho_condition(
        verts, model.tri, JFV.get_color(model, tex_c)[0],
        JP.ortho_view_rotations()["front"], JP.ORTHO_K, 256)
    want_png = np.asarray(img).astype(np.uint8)
    got_png = cv2.cvtColor(cv2.imread(os.path.join(
        save, "0", "ortho_front_render_256_baseGama.png")), cv2.COLOR_BGR2RGB)
    assert want_png.any()
    assert np.abs(got_png.astype(int) - want_png.astype(int)).max() <= 1


def test_split_matches_jax_and_loads(run, jax_fits, tmp_path):
    _, want = jax_fits
    # havatar_tpu's writers on the JAX fits, in a tree laid out as the CLI's
    base = str(tmp_path / "jax")
    save = os.path.join(base, "tracking")
    os.makedirs(base)
    os.symlink(os.path.join(run["base"], f"mv_rgb{RES}"),
               os.path.join(base, f"mv_rgb{RES}"))
    for i, (coeffs, _, head_T, extr) in enumerate(want):
        JP.save_frame_assets(save, str(i), coeffs, head_T=head_T, extr=extr,
                             transformation=extr)
    cam_K = [[1315.0, 0, RES / 2], [0, 1315.0, RES / 2], [0, 0, 1]]
    calib = {"img_res": RES, "intrinsics": {"0": {
        "cam_K": cam_K, "cam_T": np.eye(4).tolist()}}}
    want_split = json.loads(open(JP.make_transform(
        base, save, calib, ["0"], "10", shuffle=False)).read())
    got_split = json.loads(open(run["out"]["split"]).read())
    assert run["out"]["split"] == os.path.join(run["base"], "sv_v31_all.json")
    got_frames = sorted(got_split.pop("frames"), key=lambda f: f["fidx"])
    want_frames = want_split.pop("frames")
    assert [f["fidx"] for f in got_frames] == [10, 11]
    assert (json.dumps(got_split).replace(run["base"], "B")
            == json.dumps(want_split).replace(base, "B"))
    for g, w in zip(got_frames, want_frames):
        np.testing.assert_allclose(g["head_transformation"],
                                   w["head_transformation"], atol=1e-4)
        for gv, wv in zip(g["mutiview_info_ls"], w["mutiview_info_ls"]):
            for key in ("transform_matrix", "transform_matrix_ori"):
                np.testing.assert_allclose(gv[key], wv[key], atol=1e-4)

    cfg = CfgNode({"experiment": {"patch_rgb": False},
                   "dataset": {"near": -1.6, "far": 1.0, "length": 1.0,
                               "num_random_rays": 16, "cond_render_res": 64}})
    item = AvatarDataset(run["out"]["split"], "train", cfg).load_item(0)
    assert item["mv_rays"].shape == (16, 12)
    assert np.isfinite(item["mv_rays"]).all()


NET_RES, NET_FRAMES = 64, 3


@pytest.fixture(scope="module")
def net_inputs(run):
    """Seeded weight files in the reference's layouts (the landmark and
    detection nets with ``confident_heads_``), and a 3-frame video with its
    landmarks for the fit."""
    import cv2

    tmp = run["tmp"] / "nets"
    tmp.mkdir()
    files = {}
    for flag, make in (
            ("--lm_weights", lambda: L.seeded_net("landmark", 21, 3, True)),
            ("--detect_weights", lambda: L.seeded_net("detection", 22,
                                                      confident=True)),
            ("--rvm_path", lambda: RVM.seeded_rvm(23))):
        files[flag] = str(tmp / f"{flag[2:]}.pth")
        torch.save(make().state_dict(), files[flag])
    rng = np.random.RandomState(24)
    video = str(tmp / "input.avi")
    vw = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"MJPG"), 10,
                         (NET_RES, NET_RES))
    for _ in range(NET_FRAMES):
        frame = (rng.rand(NET_RES, NET_RES, 3) * 60).astype(np.uint8)
        frame[12:52, 16:48] = 200
        vw.write(frame)
    vw.release()
    lms_dir = tmp / "lms"
    lms_dir.mkdir()
    for i in range(NET_FRAMES):
        np.save(lms_dir / f"{i}.npy", _landmarks(rng, i))
    argv = ["--video_path", video, "--faceverse_path", run["fv_path"],
            "--exp52_path", str(tmp / "none"), "--lms_dir", str(lms_dir),
            "--tar_size", str(NET_RES), "--first_frame_iters", "2",
            "--frame_iters", "1", "--base_zero_frame", "1"]
    return dict(tmp=tmp, files=files, argv=argv)


@pytest.mark.parametrize("flags", [["--lm_weights"],
                                   ["--lm_weights", "--detect_weights"],
                                   ["--rvm_path", "--rvm_jax"]])
def test_network_flags_match_jax_cli(net_inputs, flags, monkeypatch):
    """The port's CLI and havatar_tpu's, on the CPU, under the networks'
    flags: the same crop_param.json and mv_rgb frames, masks at most one
    level apart (the RVM's alpha agrees within 5e-4 before it is rounded to
    uint8), each frame fitted and the split written."""
    import cv2

    from havatar_tpu.cli import fit_video as jax_cli

    extra = []
    for f in flags:
        extra += [f] if f == "--rvm_jax" else [f, net_inputs["files"][f]]
    bases = {}
    for tag in ("port", "jax"):
        base = str(net_inputs["tmp"] / f"{'_'.join(flags)}_{tag}")
        if "--rvm_path" not in flags:
            mask_dir = os.path.join(base, f"mv_mask{NET_RES}", "0")
            os.makedirs(mask_dir)
            m = np.zeros((NET_RES, NET_RES), np.uint8)
            m[8:-8, 8:-8] = 255
            for i in range(NET_FRAMES):
                cv2.imwrite(os.path.join(mask_dir, f"{i}.png"), m)
        argv = net_inputs["argv"] + ["--base_dir", base] + extra
        if tag == "port":
            out = fit_video.main(argv + ["--device", "cpu"])
            assert out["frames"] == [str(i) for i in range(NET_FRAMES)]
        else:
            monkeypatch.setattr("sys.argv", ["fit_video"] + argv)
            jax_cli.main()
        assert os.path.exists(os.path.join(base, "sv_v31_all.json"))
        bases[tag] = base
    assert (open(os.path.join(bases["port"], "crop_param.json")).read()
            == open(os.path.join(bases["jax"], "crop_param.json")).read())
    for d in (f"mv_rgb{NET_RES}/0", f"mv_mask{NET_RES}/0"):
        names = sorted(os.listdir(os.path.join(bases["port"], d)))
        assert names == [f"{i}.png" for i in range(NET_FRAMES)]
        for n in names:
            got, want = (cv2.imread(os.path.join(bases[t], d, n)).astype(int)
                         for t in ("port", "jax"))
            assert np.abs(got - want).max() <= (1 if "mask" in d else 0)
            if "mask" in d:
                assert 0 < got.mean() < 255


def test_no_device_needs_cuda(run):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fit_video.main(run["argv"])
