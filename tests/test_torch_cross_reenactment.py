"""Cross-reenactment on the port, end to end on the CPU, against
havatar_tpu's serving loop.

The port's counterpart of tests/test_cross_reenactment.py. A drive
tracking (three fitted frames on tests/test_fit_video_e2e.py's synthetic
FaceVerse dict, with other expressions and head poses than the avatar's
base frame) goes through the port's ``animation.video_animation`` (the
drive frames' condition renders) and ``make_animation_transform`` (a
``drive_drive.json`` split: no image, mask or background paths; the
conditions from each frame's ``drive/`` directory), then through
``cli.reenact.main(--precision exact --device cpu)`` on
tests/test_torch_serve.py's seeded tiny_hd checkpoint. havatar_tpu's
``run_reenactment`` serves the same split from the same ``.pt`` file. The
bounds are tests/test_torch_serve.py::test_cli_frames_equal_the_jax_loops':
the same file names, 64x64x3 frames, PNG values at most 1 apart in uint8 on
at most 0.1% of the values. Two drive frames with different expressions
have different conditions and give different frames.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax

from havatar_tpu.infer import reenact as JI
from havatar_tpu_torch.cli import reenact as TCli
from havatar_tpu_torch.data.image_io import imread_rgb
from havatar_tpu_torch.infer import reenact as TI
from havatar_tpu_torch.preprocess import animation as TA
from havatar_tpu_torch.preprocess import faceverse as TFV
from havatar_tpu_torch.preprocess.pipeline import (
    make_animation_transform,
    save_frame_assets,
)

from test_fit_video_e2e import make_fake_faceverse
from test_torch_serve import TINY_HD, _pngs, jax_side, scene  # noqa: F401

RES = 64                         # tiny_hd's split resolution
DRIVE = ("0", "1", "2")


def _coeffs(rng, exp_scale):
    c = np.zeros(150 + 171 + 251 + 38, np.float32)
    c[:150] = rng.randn(150) * 0.5
    c[150:321] = np.abs(rng.randn(171)) * exp_scale
    c[321:572] = rng.randn(251) * 0.5
    c[-1] = 1.0
    return c


def _roty(a):
    T = np.eye(4, dtype=np.float32)
    T[0, 0] = T[2, 2] = np.cos(a)
    T[0, 2], T[2, 0] = np.sin(a), -np.sin(a)
    return T


@pytest.fixture(scope="module")
def drive_split(tmp_path_factory):
    """The avatar's base frame (the camera of tests/make_synthetic_dataset.py
    as its transformation's inverse), a drive tracking of three frames,
    their condition renders and the drive split."""
    tmp = tmp_path_factory.mktemp("cross")
    rng = np.random.RandomState(5)
    fv_path = str(tmp / "fv.npy")
    make_fake_faceverse(fv_path)
    model = TFV.load_model_file(fv_path, device="cpu")
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 3] = [0.0, 0.3, 3.0]
    c2w[2, 2] = -1.0
    avatar = str(tmp / "avatar")
    save_frame_assets(avatar, "10", _coeffs(rng, 0.2), np.eye(4),
                      np.linalg.inv(c2w), np.linalg.inv(c2w))
    track = str(tmp / "drive" / "tracking")
    for k, fid in enumerate(DRIVE):
        save_frame_assets(track, fid, _coeffs(rng, 0.5 + k),
                          _roty(0.15 * k), np.eye(4), np.eye(4))
    n = TA.video_animation(model, track, os.path.join(avatar, "10"), "drive")
    assert n == len(DRIVE)
    K = np.asarray([[RES, 0, RES / 2], [0, RES, RES / 2], [0, 0, 1]],
                   np.float32)
    split = make_animation_transform(
        str(tmp / "drive"), track, {"img_res": RES, "intrinsics": {}}, "0", K,
        avatar_baseframe_path=os.path.join(avatar, "10"),
        drive_dir_name="drive")
    return dict(split=split, track=track, tmp=tmp)


def test_drive_split_layout(drive_split):
    meta = json.load(open(drive_split["split"]))
    assert os.path.basename(drive_split["split"]) == "drive_drive.json"
    assert [f["fidx"] for f in meta["frames"]] == [0, 1, 2]
    assert "bg_path" not in meta
    for f in meta["frames"]:
        assert f["inst_dir"].endswith(os.path.join(str(f["fidx"]), "drive"))
        (view,) = f["mutiview_info_ls"]
        assert "file_path" not in view and "mask_path" not in view
    a, b = (imread_rgb(os.path.join(drive_split["track"], fid, "drive",
                                    "ortho_front_render_256_baseGama.png"))
            for fid in ("0", "2"))
    assert a.any() and not np.array_equal(a, b)


def test_drive_frames_equal_the_jax_loop(drive_split, scene, jax_side,
                                         tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(jax, "device_count", lambda *a: 1)
    monkeypatch.setattr(
        TI, "mean_style",
        lambda style_dim, n=1000, seed=42, device=None:
        torch.from_numpy(jax_side["style"].copy()).to(device))
    out_t, out_j = str(tmp_path / "port"), str(tmp_path / "jax")
    stats_t = TCli.main(["--config", TINY_HD, "--ckpt", scene["ckpt"],
                         "--split", drive_split["split"], "--savedir", out_t,
                         "--precision", "exact", "--device", "cpu"])
    capsys.readouterr()
    stats_j = JI.run_reenactment(
        jax_side["cfg"], drive_split["split"], out_j, jax_side["variables"],
        jax_side["latents"], jax_side["g_ema"],
        seed=jax_side["cfg"].experiment.randomseed, precision="exact")
    assert stats_t["frames"] == stats_j["frames"] == len(DRIVE)
    got, want = _pngs(out_t), _pngs(out_j)
    assert list(got) == list(want) == [f"{f}_00.png" for f in DRIVE]
    inside = 0
    for name in want:
        g, w = got[name].astype(np.int16), want[name].astype(np.int16)
        assert g.shape == w.shape == (RES, RES, 3), name
        diff = np.abs(g - w)
        assert diff.max() <= 1, (name, diff.max())
        assert (diff > 0).mean() <= 1e-3, (name, (diff > 0).mean())
        inside += int(((w > 0) & (w < 255)).sum())
    assert inside > 0.2 * RES * RES * 3 * len(want), inside
    assert not np.array_equal(want["0_00.png"], want["2_00.png"])
