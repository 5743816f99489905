"""The stage-2 training CLI of the port end to end on the CPU, its checkpoint
read back by havatar_tpu and served by the port's reenactment CLI.

``tests/make_synthetic_dataset.py``'s dataset goes through the port's
stage-1 CLI (one step) and then ``cli.train_avatarHD.main`` with
``tests/configs/tiny_hd.yml`` (a sample grid every 2 iterations) and
``--device cpu``: three iterations warm-started from the stage-1 file, then
a resume for one more with ``--fast-step --fused-quad``. The stage-2 file
loads through ``havatar_tpu.checkpoints.convert.convert_stage2_checkpoint``
into the parameters the port holds, and ``cli.reenact`` serves it.
"""

import functools
import os
import pathlib
import shutil
import sys

import numpy as np
import pytest
import torch

import torch._dynamo  # noqa: F401  (see tests/test_torch_train.py)

from havatar_tpu.checkpoints import convert as JConv
from havatar_tpu_torch.checkpoints import io as ckpt_io
from havatar_tpu_torch.checkpoints.convert import from_jax_params
from havatar_tpu_torch.cli import reenact as reenact_cli
from havatar_tpu_torch.cli import train_avatar as stage1_cli
from havatar_tpu_torch.cli import train_avatarHD as cli
from havatar_tpu_torch.cli.common import resolve_config
from havatar_tpu_torch.data.image_io import imread_rgb

sys.path.insert(0, os.path.dirname(__file__))
from make_synthetic_dataset import make_dataset  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
TINY_HD = str(ROOT / "tests" / "configs" / "tiny_hd.yml")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_hd")
    data = str(root / "data")
    split = make_dataset(data, num_frames=4, img_res=64, cond_res=64)
    s1 = stage1_cli.main(["--datadir", data, "--logdir", str(root / "s1"),
                          "--config", TINY_HD, "--max-iters", "1",
                          "--pretrain-iters", "1", "--device", "cpu"])
    cfg = resolve_config(TINY_HD)
    cfg.experiment.validate_every = 2
    config = str(root / "hd.yml")
    with open(config, "w") as f:
        f.write(cfg.dump())
    stage1_ckpt = os.path.join(s1["checkpoint_dir"], "ckpt_00000001.pt")
    logdir = str(root / "hd")
    stats = cli.main(["--datadir", data, "--logdir", logdir, "--config",
                      config, "--ckpt", stage1_ckpt, "--max-iters", "3",
                      "--device", "cpu"])
    yield dict(root=root, data=data, split=split, config=config,
               stage1_ckpt=stage1_ckpt, logdir=logdir, stats=stats)
    # a tiny stage-2 checkpoint is still about 1 GB (the GAN nets keep 512
    # channels at their small resolutions): free the disk
    shutil.rmtree(root, ignore_errors=True)


def test_fresh_run_trains_and_writes_its_records(run):
    """Three iterations from the stage-1 warm start: finite PSNR, D and G
    losses every iteration, R1 at iteration 0 only (d_reg_every 16), the
    g_ema sample grid at iteration 2 (rows of sample | render | target,
    64 x 192 each), the config dump, a checkpoint of 3 finished
    iterations."""
    st = run["stats"]
    h = st["history"]
    assert st["start"] == 0 and st["iter"] == 3 and h["iter"] == [0, 1, 2]
    for k in ("psnr", "d", "g"):
        assert np.isfinite(h[k]).all(), (k, h[k])
    assert np.isfinite(h["r1"][0]) and np.isnan(h["r1"][1:]).all()
    assert st["samples"] == [2]
    grid = imread_rgb(os.path.join(run["logdir"], "sample", "000002.png"))
    assert grid.shape == (2 * 64, 3 * 64, 3)
    assert os.path.exists(os.path.join(run["logdir"], "config.yml"))
    assert st["saved"] == [3]
    ckpt = ckpt_io.load_checkpoint(st["checkpoint_dir"])
    assert ckpt["iter"] == 3 and ckpt["step"] == 3
    assert {"nerf_render", "latent_codes", "g", "d", "g_ema",
            "nerf_optimizer", "g_optim", "d_optim"} <= set(ckpt)
    # the warm start took the stage-1 NeRF: the field moved from there
    s1 = torch.load(run["stage1_ckpt"], weights_only=False)
    w0 = "model_coarse.layers_xyz.0.weight"
    delta = (ckpt["nerf_render"][w0] - s1["trainer_state_dict"][w0]).abs()
    assert 0 < float(delta.max()) < 0.1


def test_resume_with_the_fast_step_and_the_quad_op(run, tmp_path, capsys):
    """--continue-training from the run's checkpoint directory starts at
    iteration 3 with its state; a fused D + G iteration through the quad op
    (its twins here) follows. A stage-2 file without --continue-training,
    or a stage-1 file with it, is refused."""
    st = cli.main(["--datadir", run["data"], "--logdir", str(tmp_path / "r"),
                   "--config", run["config"], "--ckpt",
                   run["stats"]["checkpoint_dir"], "--continue-training",
                   "--max-iters", "4", "--fast-step", "--fused-quad",
                   "--device", "cpu"])
    assert st["start"] == 3 and st["iter"] == 4
    assert st["history"]["iter"] == [3]
    assert np.isfinite(st["history"]["psnr"]).all()
    ckpt = ckpt_io.load_checkpoint(st["checkpoint_dir"])
    assert ckpt["iter"] == 4 and ckpt["step"] == 4
    shutil.rmtree(st["checkpoint_dir"])
    with pytest.raises(SystemExit, match="continue-training"):
        cli.main(["--datadir", run["data"], "--logdir", str(tmp_path / "x"),
                  "--config", run["config"], "--ckpt",
                  run["stats"]["checkpoint_dir"], "--max-iters", "4",
                  "--device", "cpu"])
    with pytest.raises(SystemExit, match="stage-2"):
        cli.main(["--datadir", run["data"], "--logdir", str(tmp_path / "y"),
                  "--config", run["config"], "--ckpt", run["stage1_ckpt"],
                  "--continue-training", "--max-iters", "4",
                  "--device", "cpu"])
    capsys.readouterr()


def test_checkpoint_loads_through_havatar_tpu_converter(run):
    """convert_stage2_checkpoint reads the port's file (its converters
    bound to the tiny sizes: they assume the production 64^3 volume and
    512 / 128 images): iter, the latent codes, and the renderer, g, d and
    g_ema parameters equal to the file's (carried back with
    from_jax_params)."""
    path = os.path.join(run["stats"]["checkpoint_dir"], "ckpt_00000003.pt")
    cfg = resolve_config(TINY_HD)
    su = cfg.models.StyleUnet
    mp = pytest.MonkeyPatch()
    mp.setattr(JConv, "convert_volume_decoder", functools.partial(
        JConv.convert_volume_decoder, final_res=cfg.models.coarse.skin_vol_res))
    mp.setattr(JConv, "convert_styleunet", functools.partial(
        JConv.convert_styleunet, out_size=su.out_size, inp_size=su.inp_size,
        n_mlp=cfg.gan.n_mlp))
    mp.setattr(JConv, "convert_discriminator", functools.partial(
        JConv.convert_discriminator, size=su.out_size))
    try:
        out = JConv.convert_stage2_checkpoint(path)
    finally:
        mp.undo()
    ckpt = ckpt_io.load_checkpoint(path)
    assert out["iter"] == 3 and out["enc_mode"] == "split"
    np.testing.assert_array_equal(out["latent_codes"],
                                  ckpt["latent_codes"].numpy())
    pairs = [(from_jax_params(out["variables"]), ckpt["nerf_render"])] + [
        (from_jax_params(out[k]), ckpt[k]) for k in ("g", "d", "g_ema")]
    for back, sd in pairs:
        assert set(back) == set(sd)
        for k, v in back.items():
            np.testing.assert_array_equal(v.numpy(), sd[k].numpy(),
                                          err_msg=k)


def test_the_trained_checkpoint_serves(run, tmp_path, capsys):
    """cli.reenact serves the stage-2 file: two 64^2 frames, finite,
    written as PNGs."""
    path = os.path.join(run["stats"]["checkpoint_dir"], "ckpt_00000003.pt")
    out = str(tmp_path / "served")
    stats = reenact_cli.main(["--config", TINY_HD, "--ckpt", path, "--split",
                              run["split"], "--savedir", out,
                              "--max-frames", "2", "--device", "cpu"])
    assert stats["frames"] == 2
    files = sorted(os.listdir(os.path.join(out, "rgb")))
    assert len(files) == 2
    img = imread_rgb(os.path.join(out, "rgb", files[0]))
    assert img.shape == (64, 64, 3)
    capsys.readouterr()
