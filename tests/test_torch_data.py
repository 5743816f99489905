"""The port's host side against havatar_tpu's: the config loader, the
dataset and Loader, image I/O, the prefetcher and the checkpoint file.

These modules are numpy and file code copied into the port (which may import
nothing of havatar_tpu), so the two packages must give the same arrays
exactly for the same files and seed.
"""

import os
import sys

import numpy as np
import pytest
import torch

from havatar_tpu.data import dataset as JD
from havatar_tpu.ops import rays as JRays
from havatar_tpu.utils import cfgnode as JC
from havatar_tpu_torch.checkpoints import stage2
from havatar_tpu_torch.cli.common import resolve_config
from havatar_tpu_torch.data import dataset as TD
from havatar_tpu_torch.data import image_io
from havatar_tpu_torch.data.prefetch import device_prefetch
from havatar_tpu_torch.ops import rays as TRays
from havatar_tpu_torch.utils import cfgnode as TC

sys.path.insert(0, os.path.dirname(__file__))
from make_synthetic_dataset import make_dataset  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YMLS = ["havatar_tpu/config/singleview_512_base.yml",
        "havatar_tpu/config/singleview_512_HD_base.yml",
        "tests/configs/tiny.yml", "tests/configs/tiny_hd.yml"]


@pytest.mark.parametrize("yml", YMLS)
def test_load_config_equals_the_jax_packages(yml):
    path = os.path.join(ROOT, yml)
    want, got = JC.load_config(path), TC.load_config(path)
    assert isinstance(got, TC.CfgNode)
    assert got.to_dict() == want.to_dict()
    assert got.dump() == want.dump()
    assert got.experiment.randomseed == want.experiment.randomseed
    got.merge_from_list(["experiment.randomseed", "9", "dataset.near",
                         "-1.0"])
    want.merge_from_list(["experiment.randomseed", "9", "dataset.near",
                          "-1.0"])
    assert got.to_dict() == want.to_dict()
    with pytest.raises(AttributeError):
        got.freeze().experiment.randomseed = 1


@pytest.mark.parametrize("name", ["singleview_512_base.yml",
                                  "singleview_512_HD_base.yml"])
def test_builtin_configs_are_copies_of_the_jax_packages(name):
    """resolve_config finds the port's own copy by name, and the copy says
    what havatar_tpu's file says."""
    want = JC.load_config(os.path.join(ROOT, "havatar_tpu/config", name))
    assert resolve_config(name).to_dict() == want.to_dict()
    with pytest.raises(FileNotFoundError):
        resolve_config("no_such_config.yml")


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    return make_dataset(str(tmp_path_factory.mktemp("synth")), num_frames=3)


def _equal_items(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("mode,full_image,down_sample,patch", [
    ("train", False, 1.0, False), ("train", False, 1.0, True),
    ("train", True, 0.25, False), ("val", False, 0.5, False),
    ("test", True, 0.25, False)])
def test_dataset_equals_the_jax_packages(synth, tmp_path, mode, full_image,
                                         down_sample, patch):
    """Every item of the synthetic split, in train (importance-sampled rays
    and LPIPS patches, drawn from the same seed), val and test mode, stage-1
    and full-image: arrays equal exactly. A 64^2 patch needs frames larger
    than the 64^2 default."""
    if patch:
        synth = make_dataset(str(tmp_path), num_frames=3, img_res=128)
    cfg = TC.load_config(os.path.join(ROOT, "tests/configs/tiny.yml"))
    cfg.experiment.patch_rgb = patch
    kw = dict(mode=mode, cfg=cfg, down_sample=down_sample,
              full_image=full_image, seed=3)
    want, got = JD.AvatarDataset(synth, **kw), TD.AvatarDataset(synth, **kw)
    assert len(got) == len(want) == 3
    for i in range(len(want)):
        _equal_items(got.load_item(i), want.load_item(i))


@pytest.mark.parametrize("workers", [1, 3])
def test_loader_equals_the_jax_packages(synth, workers):
    cfg = TC.load_config(os.path.join(ROOT, "tests/configs/tiny.yml"))
    kw = dict(mode="val", cfg=cfg, down_sample=0.5)
    lkw = dict(batch_size=2, shuffle=True, seed=5, drop_last=False,
               num_workers=workers)
    want = list(JD.Loader(JD.AvatarDataset(synth, **kw), **lkw))
    got = list(TD.Loader(TD.AvatarDataset(synth, **kw), **lkw))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        _equal_items(g, w)
    it = TD.infinite(TD.Loader(TD.AvatarDataset(synth, **kw), batch_size=3))
    assert next(it)["mv_rays"].shape == next(it)["mv_rays"].shape


def test_ray_helpers_equal_the_jax_packages():
    rng = np.random.RandomState(0)
    mask = (rng.rand(12, 9) > 0.6).astype(np.float32)
    np.testing.assert_array_equal(
        TRays.make_ray_importance_sampling_map(mask, 0.95),
        JRays.make_ray_importance_sampling_map(mask, 0.95))
    T = rng.randn(4, 4).astype(np.float32)
    np.testing.assert_array_equal(TD.inv_head_transform(T),
                                  JD.inv_head_transform(T))


def test_image_io_round_trip(tmp_path):
    """imwrite_rgb -> imread_rgb gives the array back (PNG is lossless),
    what the file holds is what OpenCV writes for the same pixels, and
    resize is OpenCV's."""
    import cv2

    rng = np.random.RandomState(1)
    img = (rng.rand(20, 14, 3) * 255).astype(np.uint8)
    path = str(tmp_path / "a.png")
    image_io.imwrite_rgb(path, img)
    np.testing.assert_array_equal(image_io.imread_rgb(path), img)
    np.testing.assert_array_equal(cv2.imread(path)[..., ::-1], img)
    np.testing.assert_array_equal(JD._imread_rgb(path), img)
    sq = (rng.rand(16, 16, 3) * 255).astype(np.uint8)
    np.testing.assert_array_equal(image_io.resize(sq, size=8),
                                  JD._resize(sq, size=8))
    np.testing.assert_array_equal(image_io.resize(sq, scale=0.5, area=False),
                                  JD._resize(sq, scale=0.5, area=False))
    with pytest.raises(FileNotFoundError):
        image_io.imread_rgb(str(tmp_path / "missing.png"))
    assert image_io.CODEC == "cv2"


def test_device_prefetch_on_the_cpu():
    """Named keys become tensors on the device, the rest passes through, the
    order is kept, and an error in the producer reaches the consumer."""
    def batches(n, fail_at=None):
        for i in range(n):
            if i == fail_at:
                raise OSError("decode failed")
            yield {"a": np.full((2, 3), i, np.float32), "b": np.arange(i + 1),
                   "fidx": np.asarray([i])}

    out = list(device_prefetch(batches(5), size=2, device="cpu", keys={"a"}))
    assert [int(b["a"][0, 0]) for b in out] == list(range(5))
    assert all(isinstance(b["a"], torch.Tensor) for b in out)
    assert all(isinstance(b["b"], np.ndarray) for b in out)
    every = next(iter(device_prefetch(batches(1), device="cpu")))
    assert isinstance(every["b"], torch.Tensor)
    with pytest.raises(OSError, match="decode failed"):
        list(device_prefetch(batches(4, fail_at=2), size=1, device="cpu",
                             keys={"a"}))


def test_stage2_checkpoint_file_round_trip(tmp_path):
    """stage2_checkpoint -> torch.save -> load_stage2_checkpoint gives the
    state_dicts back; latent codes inside nerf_render are moved out; a
    directory is refused with a message that names orbax."""
    lin, g = torch.nn.Linear(3, 2), torch.nn.Linear(2, 2)
    sd = stage2.stage2_checkpoint(lin, g, torch.arange(6.).reshape(2, 3), 7)
    sd["nerf_render"]["latent_codes"] = torch.zeros(2, 3)
    path = str(tmp_path / "latest.pt")
    torch.save(sd, path)
    ck = stage2.load_stage2_checkpoint(path)
    assert set(ck["nerf_render"]) == {"weight", "bias"}
    assert torch.equal(ck["nerf_render"]["weight"], lin.weight)
    assert torch.equal(ck["g_ema"]["bias"], g.bias)
    assert torch.equal(ck["latent_codes"], torch.arange(6.).reshape(2, 3))
    assert ck["iter"] == 7 and ck["enc_mode"] == "shared_backbone"
    with pytest.raises(ValueError, match="orbax"):
        stage2.load_stage2_checkpoint(str(tmp_path))
