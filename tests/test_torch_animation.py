"""havatar_tpu_torch.preprocess.animation against havatar_tpu's, on the CPU.

``transplant_coeffs`` is host numpy in both packages and must agree bit for
bit, in both modes, pupils included (and mirror
tests/test_data_and_preprocess.py::test_animation_transplant).
``video_animation`` (absolute and incremental expressions, smoothed and
not) on a drive tracking whose frame names sort differently as strings
and as numbers, and ``audio_animation`` on 171-d and 121-d rows (smoothed
and not), on tests/test_fit_video_e2e.py's synthetic FaceVerse dict: the
same files in the same directories; the vertices and colours each frame's
render is given atol 1e-5; the first frame's front view as floats atol
1e-3 (the condition-render bound of tests/test_torch_preprocess.py); the
PNGs at most 1 apart in uint8 on at most 0.1% of the values (a value
within float32 rounding of an integer may truncate the other way).

Inputs from numpy RandomState; float32; the JAX side on the CPU.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from havatar_tpu.preprocess import animation as JA
from havatar_tpu.preprocess import faceverse as JFV
from havatar_tpu.preprocess import pipeline as JP
from havatar_tpu.preprocess.rasterizer import (
    render_ortho_condition as j_render)
from havatar_tpu_torch.data.image_io import imread_rgb
from havatar_tpu_torch.preprocess import animation as TA
from havatar_tpu_torch.preprocess import faceverse as TFV
from havatar_tpu_torch.preprocess import pipeline as TP
from havatar_tpu_torch.preprocess.rasterizer import (
    render_ortho_condition as t_render)

from test_fit_video_e2e import make_fake_faceverse

EXP = 171
DIM = 150 + EXP + 251 + 38
DRIVE_FRAMES = ("9", "10", "11")     # "10" < "11" < "9" as strings


def _coeffs(rng):
    c = np.zeros(DIM, np.float32)
    c[:150] = rng.randn(150) * 0.5
    c[150:150 + EXP] = np.abs(rng.randn(EXP)) * 0.5
    c[150 + EXP:150 + EXP + 251] = rng.randn(251) * 0.5
    a = 150 + EXP + 251
    c[a:a + 3] = rng.randn(3) * 0.1
    c[a + 3:a + 30] = rng.randn(27) * 0.1
    c[a + 30:a + 33] = rng.randn(3) * 0.1
    c[a + 33:a + 37] = rng.randn(4) * 0.1
    c[-1] = 1.0 + 0.05 * rng.randn()
    return c


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("animation")
    path = str(tmp / "fv.npy")
    make_fake_faceverse(path)
    md = np.load(path, allow_pickle=True).item()
    return JFV.load_model_dict(md), TFV.load_model_dict(md, device="cpu")


class _M:
    exp_dims = 52


@pytest.mark.parametrize("exp_dims", [52, 171])
def test_transplant_matches_jax_bit_for_bit(exp_dims):
    M = type("M", (), {"exp_dims": exp_dims})
    rng = np.random.RandomState(exp_dims)
    dim = 150 + exp_dims + 251 + 38
    all_dims = 150 + exp_dims + 251
    avatar, actor, base = (rng.randn(3, dim) * 10.0 ** rng.uniform(
        -4, 1, (3, dim))).astype(np.float32)
    for incre, b in ((True, base), (False, None)):
        got = TA.transplant_coeffs(M, avatar, actor, b, incre_expr=incre)
        want = JA.transplant_coeffs(M, avatar, actor, b, incre_expr=incre)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got[all_dims + 33:all_dims + 37],
                                      actor[all_dims + 33:all_dims + 37])
    # the JAX package's own test, on the port
    dim = 150 + 52 + 251 + 38
    out = TA.transplant_coeffs(_M, np.zeros(dim, np.float32),
                               np.full(dim, 2, np.float32),
                               np.ones(dim, np.float32), incre_expr=True)
    np.testing.assert_allclose(out[150:202], 1.0)
    np.testing.assert_allclose(out[:150], 0.0)
    np.testing.assert_allclose(out[150 + 52 + 251 + 33:150 + 52 + 251 + 37],
                               2.0)
    out2 = TA.transplant_coeffs(_M, np.zeros(dim, np.float32),
                                np.full(dim, 2, np.float32), None,
                                incre_expr=False)
    np.testing.assert_allclose(out2[150:202], 2.0)
    with pytest.raises(ValueError):
        TA.transplant_coeffs(_M, out, out, None, incre_expr=True)


def _record(monkeypatch, module, frames):
    """Wrap ``module.render_condition_set`` to keep each call's vertices
    and colours as numpy, by output directory."""
    real = module.render_condition_set

    def wrapped(model, vs, colors, out_dir, *a, **kw):
        frames[out_dir] = (np.asarray(vs), np.asarray(colors))
        return real(model, vs, colors, out_dir, *a, **kw)

    monkeypatch.setattr(module, "render_condition_set", wrapped)


def _same_outputs(models, got_frames, want_frames, got_root, want_root):
    """Same directories and files; vertices, colours, the first frame's
    float front view and the PNGs within the module docstring's bounds."""
    jm, tm = models
    rel = lambda d, root: os.path.relpath(d, root)  # noqa: E731
    assert ([rel(d, got_root) for d in got_frames]
            == [rel(d, want_root) for d in want_frames])
    for (gd, (gv, gc)), (wd, (wv, wc)) in zip(got_frames.items(),
                                              want_frames.items()):
        np.testing.assert_allclose(gv, wv, atol=1e-5, err_msg=gd)
        np.testing.assert_allclose(gc, wc, atol=1e-5, rtol=1e-6, err_msg=gd)
        names = sorted(os.listdir(gd))
        assert names == sorted(os.listdir(wd)) and len(names) == 6
        for n in names:
            g = imread_rgb(os.path.join(gd, n)).astype(np.int16)
            w = imread_rgb(os.path.join(wd, n)).astype(np.int16)
            diff = np.abs(g - w)
            assert diff.max() <= 1, (gd, n, diff.max())
            assert (diff > 0).mean() <= 1e-3, (gd, n)
    (_, (gv, gc)), (_, (wv, wc)) = (next(iter(got_frames.items())),
                                    next(iter(want_frames.items())))
    verts_t = TP.BoxWarp.from_bounds(TP.CANONICAL_BOUNDS)(torch.from_numpy(gv))
    img_t, _ = t_render(verts_t, tm.tri, torch.from_numpy(gc),
                        TP.ortho_view_rotations("cpu")["front"], TP.ORTHO_K,
                        256)
    verts_j = JP.BoxWarp(*JP.get_box_warp_param(*JP.CANONICAL_BOUNDS))(
        jnp.asarray(wv))
    img_j, _ = j_render(verts_j, jm.tri, jnp.asarray(wc),
                        JP.ortho_view_rotations()["front"], JP.ORTHO_K, 256)
    assert np.asarray(img_j).any()
    np.testing.assert_allclose(img_t.numpy(), np.asarray(img_j), atol=1e-3)


@pytest.mark.parametrize("incre,smooth", [(True, False), (False, True)])
def test_video_animation_matches_jax(models, tmp_path, monkeypatch, incre,
                                     smooth):
    rng = np.random.RandomState(3)
    avatar = tmp_path / "avatar" / "10"
    avatar.mkdir(parents=True)
    np.save(str(avatar / "coeffs.npy"), _coeffs(rng))
    seqs = [_coeffs(rng) for _ in DRIVE_FRAMES]
    frames = {}
    for tag, module, model in (("port", TA, models[1]),
                               ("jax", JA, models[0])):
        track = tmp_path / tag
        for fid, c in zip(DRIVE_FRAMES, seqs):
            (track / fid).mkdir(parents=True)
            np.save(str(track / fid / "coeffs.npy"), c)
            (track / fid / "finish").touch()
        (track / "unfinished").mkdir()        # no finish marker: passed over
        frames[tag] = {}
        _record(monkeypatch, module, frames[tag])
        n = module.video_animation(model, str(track), str(avatar), "drive",
                                   incre_expr=incre, smooth_coeff=smooth)
        assert n == len(DRIVE_FRAMES)
    assert [os.path.basename(os.path.dirname(d)) for d in frames["port"]] \
        == sorted(DRIVE_FRAMES)
    _same_outputs(models, frames["port"], frames["jax"],
                  str(tmp_path / "port"), str(tmp_path / "jax"))


@pytest.mark.parametrize("width,smooth,incre", [(171, False, True),
                                                (171, True, False),
                                                (121, False, False),
                                                (121, True, True)])
def test_audio_animation_matches_jax(models, tmp_path, monkeypatch, width,
                                     smooth, incre):
    rng = np.random.RandomState(width + smooth)
    avatar = tmp_path / "avatar"
    avatar.mkdir()
    np.save(str(avatar / "coeffs.npy"), _coeffs(rng))
    audio = str(tmp_path / "audio.npy")
    np.save(audio, (rng.randn(2, width) * 0.3).astype(np.float32))
    frames = {}
    for tag, module, model in (("port", TA, models[1]),
                               ("jax", JA, models[0])):
        frames[tag] = {}
        _record(monkeypatch, module, frames[tag])
        n = module.audio_animation(model, audio, str(avatar),
                                   str(tmp_path / tag), incre_expr=incre,
                                   smooth_audio=smooth)
        assert n == 2
    _same_outputs(models, frames["port"], frames["jax"],
                  str(tmp_path / "port"), str(tmp_path / "jax"))
