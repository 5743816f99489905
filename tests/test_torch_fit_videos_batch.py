"""havatar_tpu_torch.cli.fit_videos_batch against havatar_tpu's, on the CPU.

On tests/test_fit_video_e2e.py's synthetic FaceVerse dict: ``render_fvmask``
against JAX's on the same coefficients within 0.1% of the pixels (the
projected corners are rounded to pixels, and a corner within float
rounding of a .5 boundary may round the other way); ``draw_lms_counter``
identical to JAX's; ``fit_video_frames`` against JAX's on one video's
landmarks at the fit bounds of
tests/test_torch_preprocess.py::test_ten_iteration_fit_matches_jax
(projected landmarks atol 1e-3 px, each frame's last loss rtol 1e-4).
The IO pool yields the same videos, frames and landmarks in the same
order at 1 and 3 workers. The whole CLI (3 videos of 3 frames at 64^2, and
a fourth with a frame without a face) writes bit-identical assets at 1
and 4 IO workers, with ``--save_fvmask`` and ``--save_lmscounter``; its
coefficients and transforms are within atol 1e-4 of JAX's CLI on the same
inputs; each frame's pose comes from its own coefficients; the video
without a face gets a ``skip`` marker and an entry in
``no_face_log.json``; a second run fits nothing.
(tests/test_data_and_preprocess.py::test_fit_videos_batch_debug_outputs,
::test_fit_videos_batch_io_fanout_deterministic and
tests/test_fit_videos_batch.py, without the subprocess.)
"""

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from havatar_tpu.cli import fit_videos_batch as JB
from havatar_tpu.preprocess import faceverse as JFV
from havatar_tpu.preprocess import fitting as JFIT
from havatar_tpu_torch.cli import fit_videos_batch as TB
from havatar_tpu_torch.preprocess import faceverse as TFV
from havatar_tpu_torch.preprocess import fitting as TFIT

from test_fit_video_e2e import make_fake_faceverse

RES, N_VIDEOS, N_FRAMES = 64, 3, 3
INTR = np.asarray([4.2647 * RES / 2, 4.2647 * RES / 2, RES / 2, RES / 2],
                  np.float32)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """tests/test_fit_videos_batch.py's videos (landmarks that drift frame
    to frame), plus ``vid3`` whose frame 1 has no landmarks."""
    import cv2

    tmp = tmp_path_factory.mktemp("fit_videos_batch")
    rng = np.random.RandomState(7)
    videos_root, lms_root = tmp / "videos", tmp / "lms"
    for v in range(N_VIDEOS + 1):
        vdir, ldir = videos_root / f"vid{v}", lms_root / f"vid{v}"
        vdir.mkdir(parents=True)
        ldir.mkdir(parents=True)
        for i in range(N_FRAMES):
            cv2.imwrite(str(vdir / f"{i}.png"),
                        (rng.rand(RES, RES, 3) * 80).astype(np.uint8))
            lms = np.stack([16 + 32 * rng.rand(478),
                            16 + 32 * rng.rand(478)], -1).astype(np.float32)
            if (v, i) != (N_VIDEOS, 1):
                np.save(str(ldir / f"{i}.npy"), lms + 2.0 * i)
    (videos_root / "notes.txt").write_text("not a video")
    fv_path = str(tmp / "fv.npy")
    make_fake_faceverse(fv_path)
    md = np.load(fv_path, allow_pickle=True).item()
    argv = ["--videos_root", str(videos_root), "--faceverse_path", fv_path,
            "--lms_root", str(lms_root), "--tar_size", str(RES),
            "--iters_first", "8", "--iters_rest", "4",
            "--save_fvmask", "fvmask", "--save_lmscounter", "lmscounter"]
    return dict(tmp=tmp, videos=str(videos_root), lms=str(lms_root),
                argv=argv, jm=JFV.load_model_dict(md),
                tm=TFV.load_model_dict(md, device="cpu"))


def _coeffs(rng):
    c = np.zeros(150 + 171 + 251 + 38, np.float32)
    c[:150] = rng.randn(150) * 0.5
    c[150:321] = np.abs(rng.randn(171)) * 0.5
    a = 150 + 171 + 251
    c[a:a + 3] = rng.randn(3) * 0.2
    c[a + 30:a + 33] = rng.randn(3) * 0.2
    c[-1] = 1.0
    return c


def test_render_fvmask_and_draw_lms_counter_match_jax(inputs):
    rng = np.random.RandomState(0)
    coeffs = np.zeros(610, np.float32)
    coeffs[-1] = 1.0
    intr = np.asarray([256.0, 256.0, 64.0, 64.0], np.float32)
    mask = TB.render_fvmask(inputs["tm"], coeffs, intr, tar_size=128)
    assert mask.shape == (128, 128) and mask.dtype == np.uint8
    assert (mask == 255).any()
    for c in (coeffs, _coeffs(rng), _coeffs(rng)):
        got = TB.render_fvmask(inputs["tm"], c, intr, 128)
        want = JB.render_fvmask(inputs["jm"], c, intr, 128)
        assert (want == 255).any()
        assert (got != want).mean() <= 1e-3
    lms = rng.rand(478, 2).astype(np.float32) * 100 + 10
    img = TB.draw_lms_counter(np.zeros((128, 128, 3), np.uint8), lms)
    assert img.shape == (128, 128, 3) and img.any()
    np.testing.assert_array_equal(
        img, JB.draw_lms_counter(np.zeros((128, 128, 3), np.uint8), lms))


def test_fit_video_frames_matches_jax(inputs):
    lms = np.stack([np.load(os.path.join(inputs["lms"], "vid0", f"{i}.npy"))
                    for i in range(N_FRAMES)])
    got, losses_t, _ = TB.fit_video_frames(
        inputs["tm"], lms, INTR, TFIT.FitConfig(img_size=RES), 8, 4)
    want, losses_j, _ = JB.fit_video_frames(
        inputs["jm"], lms, INTR, JFIT.FitConfig(img_size=RES), 8, 4)
    assert got.shape == np.asarray(want).shape == (N_FRAMES, 610)
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-4)
    for c_t, c_j in zip(got, np.asarray(want)):
        p_t, _ = TFV.forward_landmarks(inputs["tm"], torch.from_numpy(c_t[None]),
                                       *[float(v) for v in INTR])
        p_j, _ = JFV.forward_landmarks(inputs["jm"], jnp.asarray(c_j[None]),
                                       *[float(v) for v in INTR])
        np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), atol=1e-3)


def test_io_pool_order_does_not_depend_on_workers(inputs):
    names = [f"vid{v}" for v in range(N_VIDEOS + 1)]
    assert TB.collect_pending(inputs["videos"], str(inputs["tmp"] / "none")) \
        == names

    def snapshot(workers):
        return list(TB.iter_videos_prefetched(names, inputs["videos"],
                                              inputs["lms"], workers))

    s1, s3 = snapshot(1), snapshot(3)
    assert [x[0] for x in s1] == [x[0] for x in s3] == names
    for (n1, f1, l1, bad1), (_, f3, l3, bad3) in zip(s1, s3):
        assert f1 == f3 == [f"{i}.png" for i in range(N_FRAMES)]
        if n1 == f"vid{N_VIDEOS}":
            assert l1 is None and l3 is None and bad1 == bad3 == "1.png"
        else:
            assert bad1 is None and bad3 is None
            np.testing.assert_array_equal(l1, l3)


def _assets(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            rel = os.path.relpath(p, root)
            if f.endswith(".npy"):
                out[rel] = np.load(p)
            elif f.endswith(".npz"):
                with np.load(p) as z:
                    out[rel] = {k: z[k] for k in z.files}
            elif f.endswith((".png", ".json")):
                out[rel] = open(p, "rb").read()
            else:
                out[rel] = None          # markers: presence only
    return out


@pytest.fixture(scope="module")
def cli_runs(inputs):
    roots = {w: str(inputs["tmp"] / f"out_w{w}") for w in (1, 4)}
    stats = {w: TB.main(inputs["argv"] + ["--save_root", r, "--io_workers",
                                          str(w), "--device", "cpu"])
             for w, r in roots.items()}
    return roots, stats


def test_cli_outputs_do_not_depend_on_io_workers(inputs, cli_runs):
    roots, stats = cli_runs
    a, b = _assets(roots[1]), _assets(roots[4])
    assert a.keys() == b.keys()
    assert sum(k.endswith("coeffs.npy") for k in a) == N_VIDEOS * N_FRAMES
    for k, va in a.items():
        if isinstance(va, dict):
            for name in va:
                np.testing.assert_array_equal(va[name], b[k][name], err_msg=k)
        elif isinstance(va, np.ndarray):
            np.testing.assert_array_equal(va, b[k], err_msg=k)
        else:
            assert va == b[k], k
    for s in stats.values():
        assert s["fitted"] == [f"vid{v}" for v in range(N_VIDEOS)]
        assert s["skipped"] == [f"vid{N_VIDEOS}"]
        assert s["frames"] == N_VIDEOS * N_FRAMES
    for v in range(N_VIDEOS):
        assert os.path.exists(os.path.join(roots[1], f"vid{v}", "finish"))
        for i in range(N_FRAMES):
            for kind in ("fvmask", "lmscounter"):
                assert os.path.exists(os.path.join(
                    roots[1], f"vid{v}", kind, f"{i}.png"))
    # each frame's pose from its own coefficients
    with np.load(os.path.join(roots[1], "vid0", "0", "metaFace_extr.npz")) \
            as z0, np.load(os.path.join(roots[1], "vid0", "2",
                                        "metaFace_extr.npz")) as z2:
        assert not np.allclose(z0["head_T"], z2["head_T"])
    c2 = np.load(os.path.join(roots[1], "vid0", "2", "coeffs.npy"))
    _, _, _, ang, _, trans, _, scale = TFV.split_coeffs(
        torch.from_numpy(c2[None]), 171)
    with np.load(os.path.join(roots[1], "vid0", "2",
                              "metaFace_extr.npz")) as z2:
        np.testing.assert_array_equal(
            z2["head_T"], TFV.make_rot_mat(ang, trans, scale, True).numpy())
        np.testing.assert_array_equal(
            z2["extr"], TFV.make_rot_mat(ang, trans, scale, False).numpy())


def test_skip_marker_no_face_log_and_resume(inputs, cli_runs):
    roots, stats = cli_runs
    sdir = os.path.join(roots[1], f"vid{N_VIDEOS}")
    assert os.path.exists(os.path.join(sdir, "skip"))
    assert not os.path.exists(os.path.join(sdir, "finish"))
    assert os.listdir(sdir) == ["skip"]
    log = stats[1]["no_face_log"]
    assert log == os.path.join(roots[1], "no_face_log.json")
    assert json.load(open(log)) == {f"vid{N_VIDEOS}/1.png": "no_face"}
    assert TB.collect_pending(inputs["videos"], roots[1]) == []
    again = TB.main(inputs["argv"] + ["--save_root", roots[1],
                                      "--device", "cpu"])
    assert again["pending"] == again["fitted"] == again["skipped"] == []
    assert again["no_face_log"] is None


def test_cli_matches_jax_cli(inputs, cli_runs, monkeypatch, capsys):
    roots, _ = cli_runs
    jax_root = str(inputs["tmp"] / "out_jax")
    monkeypatch.setattr("sys.argv", ["fit_videos_batch"] + inputs["argv"]
                        + ["--save_root", jax_root, "--io_workers", "2"])
    JB.main()
    capsys.readouterr()
    got, want = _assets(roots[1]), _assets(jax_root)
    assert got.keys() == want.keys()
    for k, w in want.items():
        if k.endswith("coeffs.npy"):
            np.testing.assert_allclose(got[k], w, atol=1e-4, err_msg=k)
        elif k.endswith(".npz"):
            for name in w:
                np.testing.assert_allclose(got[k][name], w[name], atol=1e-4,
                                           err_msg=f"{k}:{name}")
    assert got["no_face_log.json"] == want["no_face_log.json"]
