"""The serving path as a whole: the port's CLI against havatar_tpu's
``run_reenactment`` on the same checkpoint file and driving split.

A seeded tiny port model (tests/configs/tiny_hd.yml) is written as a stage-2
``.pt`` file. The port serves it through ``cli.reenact.main`` on the CPU;
the JAX package loads the same file through its own
``cli.reenact.load_inference_weights`` and serves it with its own loop. Both
read the same synthetic split (two views, so that the ray cache holds two
cameras) and must write the same PNGs.

The two packages draw ``mean_style`` from different random generators, so
the test hands the port the JAX value. havatar_tpu's converters assume the
production depth of the skinning volume and the StyleUNet; the test binds
them to the tiny config's, and takes JAX's one-device loop (this test
process has 8 virtual CPU devices).
"""

import functools
import json
import os
import sys

import numpy as np
import pytest
import torch

import jax

from havatar_tpu.checkpoints import convert as JConv
from havatar_tpu.cli import reenact as JCli
from havatar_tpu.infer import reenact as JI
from havatar_tpu.models.generators import StyleUNetSR as JStyleUNetSR
from havatar_tpu.utils.cfgnode import load_config as j_load_config
from havatar_tpu_torch.checkpoints.stage2 import stage2_checkpoint
from havatar_tpu_torch.cli import reenact as TCli
from havatar_tpu_torch.cli.common import resolve_config
from havatar_tpu_torch.data.image_io import imread_rgb
from havatar_tpu_torch.infer import reenact as TI
from havatar_tpu_torch.models.generators import StyleUNetSR
from havatar_tpu_torch.train.stage1 import build_renderer

sys.path.insert(0, os.path.dirname(__file__))
from make_synthetic_dataset import make_dataset  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_HD = os.path.join(ROOT, "tests", "configs", "tiny_hd.yml")
N_FRAMES = 3


def _two_view_split(root):
    """The synthetic split with a second camera added to every frame."""
    split = make_dataset(root, num_frames=N_FRAMES, img_res=64, cond_res=64)
    meta = json.load(open(split))
    meta["mutiview_intr_ls"].append([70.0, 70.0, 0.5, 0.5])
    for fr in meta["frames"]:
        second = dict(fr["mutiview_info_ls"][0], view_name="1")
        c2w = np.asarray(second["transform_matrix"])
        c2w[0, 3] += 0.4
        second["transform_matrix"] = c2w.tolist()
        fr["mutiview_info_ls"].append(second)
    json.dump(meta, open(split, "w"))
    return split


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("serve")
    split = _two_view_split(str(root / "data"))
    cfg = resolve_config(TINY_HD)
    renderer = TI.seeded_init_(build_renderer(cfg), seed=1)
    sr, gan = cfg.models.StyleUnet, cfg.gan
    g_ema = TI.seeded_init_(StyleUNetSR(
        inp_size=sr.inp_size, inp_ch=sr.inp_ch, out_ch=3,
        out_size=sr.out_size, style_dim=gan.latent, n_mlp=gan.n_mlp,
        channel_multiplier=gan.channel_multiplier), seed=2)
    latents = torch.from_numpy(np.random.RandomState(3).randn(
        N_FRAMES, cfg.experiment.latent_code_dim).astype(np.float32) * .5)
    ckpt = str(root / "latest.pt")
    torch.save(stage2_checkpoint(renderer, g_ema, latents, 5), ckpt)
    return dict(split=split, ckpt=ckpt, root=root)


@pytest.fixture(scope="module")
def jax_side(scene):
    """The checkpoint file as havatar_tpu loads it, and the style it
    draws."""
    cfg = j_load_config(TINY_HD)
    sr = cfg.models.StyleUnet
    mp = pytest.MonkeyPatch()
    mp.setattr(JConv, "convert_volume_decoder", functools.partial(
        JConv.convert_volume_decoder,
        final_res=cfg.models.coarse.skin_vol_res))
    mp.setattr(JConv, "convert_styleunet", functools.partial(
        JConv.convert_styleunet, out_size=sr.out_size, inp_size=sr.inp_size,
        n_mlp=cfg.gan.n_mlp))
    try:
        variables, latents, g_ema, enc = JCli.load_inference_weights(
            scene["ckpt"])
    finally:
        mp.undo()
    assert enc == "split"
    gen = JStyleUNetSR(style_dim=cfg.gan.latent)
    style = np.asarray(JI.mean_style(
        gen, g_ema, jax.random.PRNGKey(cfg.experiment.randomseed)))
    return dict(cfg=cfg, variables=variables, latents=latents, g_ema=g_ema,
                style=style)


def _pngs(savedir):
    d = os.path.join(savedir, "rgb")
    return {n: imread_rgb(os.path.join(d, n)) for n in sorted(os.listdir(d))}


@pytest.mark.parametrize("gated", [False, True])
def test_cli_frames_equal_the_jax_loops(scene, jax_side, tmp_path,
                                        monkeypatch, capsys, gated):
    """``main([... --precision exact --device cpu])``, blind at the config's
    8 + 4 samples and ``--gated --coarse 8``, against havatar_tpu's
    run_reenactment(precision="exact") on the same files: the same file
    names, 64x64x3 frames, and PNG values that differ by at most 1 in uint8
    on at most 0.1% of the values (both sides are float32; a value that
    lands within float32 rounding of a .5 boundary may round the other
    way). The stats agree on the frame count, and the ray cache holds the
    split's two cameras."""
    monkeypatch.setattr(jax, "device_count", lambda *a: 1)
    monkeypatch.setattr(
        TI, "mean_style",
        lambda style_dim, n=1000, seed=42, device=None:
        torch.from_numpy(jax_side["style"].copy()).to(device))
    extra = ["--gated", "--coarse", "8"] if gated else []
    out_t, out_j = str(tmp_path / "port"), str(tmp_path / "jax")
    stats_t = TCli.main(["--config", TINY_HD, "--ckpt", scene["ckpt"],
                         "--split", scene["split"], "--savedir", out_t,
                         "--precision", "exact", "--device", "cpu"] + extra)
    printed = capsys.readouterr().out
    assert "Done!" in printed
    assert json.loads(printed.splitlines()[-2])["frames"] == 2 * N_FRAMES
    stats_j = JI.run_reenactment(
        jax_side["cfg"], scene["split"], out_j, jax_side["variables"],
        jax_side["latents"], jax_side["g_ema"],
        seed=jax_side["cfg"].experiment.randomseed, precision="exact",
        gated=gated, num_coarse=8 if gated else None)
    assert stats_t["frames"] == stats_j["frames"] == 2 * N_FRAMES
    assert set(stats_j) <= set(stats_t)
    assert stats_t["ray_cache_entries"] == 2
    got, want = _pngs(out_t), _pngs(out_j)
    assert list(got) == list(want) == [
        f"{f}_{v:02d}.png" for f in range(N_FRAMES) for v in (0, 1)]
    inside = 0
    for name in want:
        g, w = got[name].astype(np.int16), want[name].astype(np.int16)
        assert g.shape == w.shape == (64, 64, 3), name
        diff = np.abs(g - w)
        assert diff.max() <= 1, (name, diff.max())
        assert (diff > 0).mean() <= 1e-3, (name, (diff > 0).mean())
        inside += int(((w > 0) & (w < 255)).sum())
    # the comparison is of real values, not of frames clamped to 0 or 255
    assert inside > 0.2 * 64 * 64 * 3 * len(want), inside
    assert not np.array_equal(want["0_00.png"], want["0_01.png"])
    assert not np.array_equal(want["0_00.png"], want["1_00.png"])


def test_cli_max_frames_and_the_ray_cache(scene, tmp_path, capsys):
    """``--max-frames 3`` serves the first three items in the loader's order
    (frames by index, views within a frame), as the JAX loop does, and stops
    there; ``--precision auto`` on the CPU is the exact path."""
    out = str(tmp_path / "out")
    stats = TCli.main(["--config", TINY_HD, "--ckpt", scene["ckpt"],
                       "--split", scene["split"], "--savedir", out,
                       "--max-frames", "3", "--device", "cpu"])
    assert stats["frames"] == 3 and stats["fps"] > 0
    assert sorted(os.listdir(os.path.join(out, "rgb"))) == [
        "0_00.png", "0_01.png", "1_00.png"]
    assert stats["ray_cache_entries"] == 2
    capsys.readouterr()


def test_cli_fast_precision_serves_through_the_march_twins(scene, tmp_path,
                                                           capsys):
    """``--precision fast`` on the CPU: bf16 and the fused march (the twins
    here). tiny_hd's field has 16 feature channels, which the twins take
    and the CUDA kernels would refuse; the frames have the right shape and
    stay close to the exact path's (bf16 against float32: mean absolute
    difference under 8 of 255)."""
    fast, exact = str(tmp_path / "fast"), str(tmp_path / "exact")
    base = ["--config", TINY_HD, "--ckpt", scene["ckpt"], "--split",
            scene["split"], "--max-frames", "2", "--device", "cpu"]
    TCli.main(base + ["--savedir", fast, "--precision", "fast"])
    TCli.main(base + ["--savedir", exact, "--precision", "exact"])
    capsys.readouterr()
    a, b = _pngs(fast), _pngs(exact)
    assert list(a) == list(b) == ["0_00.png", "0_01.png"]
    for n in a:
        assert a[n].shape == (64, 64, 3)
        assert np.abs(a[n].astype(np.int16) - b[n]).mean() < 8.0, n


def test_cli_builds_the_field_the_checkpoint_names(scene, tmp_path, capsys):
    """A checkpoint whose keys name another plane encoder than the config
    overrides the config; one without latent codes or a directory is
    refused; CUDA is the default device and its absence an error."""
    cfg = resolve_config(TINY_HD)
    cfg.models.coarse.enc_mode = "shared_backbone"
    cfg.models.coarse.plane_middle_size = 16
    renderer = TI.seeded_init_(build_renderer(cfg), seed=4)
    ck = torch.load(scene["ckpt"], weights_only=False)
    ck["nerf_render"] = renderer.state_dict()
    path = str(tmp_path / "shared.pt")
    torch.save(ck, path)
    args = ["--config", TINY_HD, "--split", scene["split"], "--savedir",
            str(tmp_path / "o"), "--max-frames", "1", "--device", "cpu"]
    assert TCli.main(args + ["--ckpt", path])["frames"] == 1
    assert "overrides config 'split'" in capsys.readouterr().out
    del ck["latent_codes"]
    torch.save(ck, path)
    with pytest.raises(ValueError, match="latent_codes"):
        TCli.main(args + ["--ckpt", path])
    with pytest.raises(ValueError, match="orbax"):
        TCli.main(args + ["--ckpt", str(tmp_path)])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TCli.main(args[:-2] + ["--ckpt", scene["ckpt"]])
