"""The port's entry points with no device named, on a host without CUDA.

The port's rule (``havatar_tpu_torch/device.py``): a call that names no
device runs on the CUDA device, or raises through ``resolve_device``; it
never falls back to the CPU quietly. With ``torch.cuda.is_available``
patched to False, ``stage1.init_state``, ``stage2.init_state``,
``lpips.load_lpips_file``, ``pipeline.ortho_view_rotations`` and the new
preprocessing entry points (``fit_video_mv.main``,
``fit_videos_batch.main``) raise when no device is named, and the first
four work with ``device="cpu"``. ``render_condition_set`` takes the device
of the vertices it is given, so it still works on CPU vertices.
"""

import os

import numpy as np
import pytest
import torch

from havatar_tpu_torch.cli import fit_video_mv, fit_videos_batch
from havatar_tpu_torch.cli.common import resolve_config
from havatar_tpu_torch.preprocess import faceverse as FV
from havatar_tpu_torch.preprocess import pipeline as P
from havatar_tpu_torch.train import lpips as LP
from havatar_tpu_torch.train import stage1, stage2

from test_fit_video_e2e import make_fake_faceverse

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "tests", "configs", "tiny.yml")
TINY_HD = os.path.join(ROOT, "tests", "configs", "tiny_hd.yml")


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_stage1_init_state(no_cuda):
    cfg = resolve_config(TINY)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stage1.init_state(cfg, 2)
    state = stage1.init_state(cfg, 2, device="cpu")
    assert state.latent_codes.device.type == "cpu"
    assert all(p.device.type == "cpu" for p in state.renderer.parameters())


def test_stage2_init_state(no_cuda):
    cfg = resolve_config(TINY_HD)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stage2.init_state(cfg, 2)
    state = stage2.init_state(cfg, 2, device="cpu")
    assert state.latent_codes.device.type == "cpu"
    for module in (state.renderer, state.generator, state.discriminator,
                   state.g_ema):
        assert all(p.device.type == "cpu" for p in module.parameters())


def test_load_lpips_file(no_cuda, tmp_path):
    path = str(tmp_path / "lpips.npz")
    params = LP.init_lpips_params(torch.Generator().manual_seed(0))
    LP.save_lpips_file(params, path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LP.load_lpips_file(path)
    loaded = LP.load_lpips_file(path, device="cpu")
    w = loaded["conv"]["b0_c0"]["weight"]
    assert w.device.type == "cpu"
    np.testing.assert_array_equal(w.numpy(),
                                  params["conv"]["b0_c0"]["weight"].numpy())


def test_ortho_view_rotations_and_condition_renders(no_cuda, tmp_path):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.ortho_view_rotations()
    rots = P.ortho_view_rotations("cpu")
    assert sorted(rots) == ["front", "left", "right"]
    assert all(r.device.type == "cpu" for r in rots.values())
    fv_path = str(tmp_path / "fv.npy")
    make_fake_faceverse(fv_path)
    model = FV.load_model_file(fv_path, device="cpu")
    c = torch.zeros(1, 150 + model.exp_dims + 251 + 38)
    c[0, -1] = 1.0
    id_c, exp_c, tex_c, _, _, _, eye_c, _ = FV.split_coeffs(c, model.exp_dims)
    P.render_condition_set(model, FV.get_vs(model, id_c, exp_c, eye_c)[0],
                           FV.get_color(model, tex_c)[0], str(tmp_path / "c"))
    assert len(os.listdir(tmp_path / "c")) == 6


@pytest.mark.parametrize("cli", [fit_video_mv, fit_videos_batch])
def test_preprocessing_clis(no_cuda, tmp_path, cli):
    args = (["--base_dir", str(tmp_path), "--calib_file", "c.json",
             "--faceverse_path", "f.npy", "--views", "0"]
            if cli is fit_video_mv else
            ["--videos_root", str(tmp_path), "--save_root", str(tmp_path),
             "--faceverse_path", "f.npy"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(args)
