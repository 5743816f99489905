"""The stage-1 training CLI of the port end to end on the CPU, and its
checkpoint read back by havatar_tpu.

``tests/make_synthetic_dataset.py``'s dataset and ``tests/configs/tiny.yml``
go through ``cli.train_avatar.main`` with ``--device cpu``: a short
pretraining, three steps, a checkpoint; a second run resumes from it; the
file loads through ``havatar_tpu.checkpoints.convert.
convert_stage1_checkpoint`` into the parameters the port holds.
"""

import ast
import functools
import os
import pathlib
import sys

import numpy as np
import pytest
import torch

# torch imports torch._dynamo on the first optimizer it builds, and that
# import walks importlib specs: it raises if a test file that ran earlier in
# the same process has put a spec-less stand-in module into sys.modules (the
# preprocessing tests do, for onnxruntime). Import it while the test files
# are collected, before any test runs.
import torch._dynamo  # noqa: F401

from havatar_tpu.checkpoints import convert as JConv
from havatar_tpu_torch.checkpoints import io as ckpt_io
from havatar_tpu_torch.checkpoints.convert import from_jax_params
from havatar_tpu_torch.checkpoints.partial import merge_partial
from havatar_tpu_torch.cli import common
from havatar_tpu_torch.cli import train_avatar as cli
from havatar_tpu_torch.train.stage1 import build_renderer
from havatar_tpu_torch.utils import logging_util, obj_io, preemption
from havatar_tpu_torch.utils.profiling import StepTimer

sys.path.insert(0, os.path.dirname(__file__))
from make_synthetic_dataset import make_dataset  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
TINY = str(ROOT / "tests" / "configs" / "tiny.yml")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """One fresh run: 5 pretrain iterations, 3 steps."""
    root = tmp_path_factory.mktemp("train")
    data = str(root / "data")
    make_dataset(data, num_frames=4, img_res=64, cond_res=64)
    logdir = str(root / "logs")
    stats = cli.main(["--datadir", data, "--logdir", logdir, "--config", TINY,
                      "--max-iters", "3", "--pretrain-iters", "5",
                      "--device", "cpu"])
    return dict(data=data, logdir=logdir, stats=stats, root=root)


def test_fresh_run_trains_and_writes_its_records(run):
    """Finite, falling loss over three steps; the pretraining lowers its
    BCE; the log directory holds the config dump, the code snapshot, the
    metrics and one checkpoint in the reference's stage-1 layout."""
    st = run["stats"]
    assert st["start_step"] == 0 and st["step"] == 3
    assert len(st["losses"]) == 3 and np.isfinite(st["losses"]).all()
    assert st["losses"][-1] < st["losses"][0]
    assert len(st["pretrain_bce"]) == 5
    assert st["pretrain_bce"][-1] < st["pretrain_bce"][0]
    names = os.listdir(run["logdir"])
    assert any(n.startswith("config_") and n.endswith(".yml") for n in names)
    assert any(n.startswith("code_bk_") and n.endswith(".tar.gz")
               for n in names)
    assert os.listdir(st["checkpoint_dir"]) == ["ckpt_00000003.pt"]
    assert st["saved_steps"] == [3]
    ckpt = ckpt_io.load_checkpoint(st["checkpoint_dir"])
    assert set(ckpt) == {"iter", "optimizer_state_dict", "loss", "psnr",
                         "trainer_state_dict"}
    assert ckpt["iter"] == 3
    np.testing.assert_allclose(ckpt["loss"], st["losses"][-1], rtol=1e-6)
    keys = set(ckpt["trainer_state_dict"])
    assert "latent_codes" in keys
    assert all(k == "latent_codes" or k.startswith(
        ("model_coarse.", "headpose_skin_net.canonical_Wvolume."))
        for k in keys)
    assert tuple(ckpt["trainer_state_dict"]["latent_codes"].shape) == (4, 8)


def test_ckpt_resumes_at_the_saved_step(run, tmp_path, capsys):
    """--ckpt (the checkpoint file) restores weights, codes, Adam's moments
    and the step count: the run goes on at step 3 without pretraining, and
    two more steps end at 5 with a new checkpoint."""
    path = os.path.join(run["stats"]["checkpoint_dir"], "ckpt_00000003.pt")
    st = cli.main(["--datadir", run["data"], "--logdir", str(tmp_path / "l2"),
                   "--config", TINY, "--max-iters", "5", "--ckpt", path,
                   "--device", "cpu"])
    out = capsys.readouterr().out
    assert "resumed from step 3" in out and "pretrain" not in out
    assert st["start_step"] == 3 and st["step"] == 5
    assert st["pretrain_bce"] == [] and len(st["losses"]) == 2
    assert np.isfinite(st["losses"]).all()
    assert st["saved_steps"] == [5]
    before = ckpt_io.load_checkpoint(path)
    after = ckpt_io.load_checkpoint(st["checkpoint_dir"])
    steps = [s["step"] for s in
             after["optimizer_state_dict"]["state"].values()]
    assert steps and all(int(s) == 5 for s in steps)   # 3 restored + 2
    w0 = "model_coarse.layers_xyz.0.weight"
    assert not torch.equal(before["trainer_state_dict"][w0],
                           after["trainer_state_dict"][w0])


def test_checkpoint_loads_through_havatar_tpu_converter(run):
    """convert_stage1_checkpoint reads the port's file: iter, latent codes,
    the detected encoder variant, and parameters equal to the port's own
    (carried back with from_jax_params: exact, both are copies). The JAX
    converter assumes the production depth of the skinning volume (64^3),
    so it is bound to the tiny config's 16^3 here."""
    path = os.path.join(run["stats"]["checkpoint_dir"], "ckpt_00000003.pt")
    mp = pytest.MonkeyPatch()
    mp.setattr(JConv, "convert_volume_decoder", functools.partial(
        JConv.convert_volume_decoder, final_res=16))
    try:
        out = JConv.convert_stage1_checkpoint(path)
    finally:
        mp.undo()
    ckpt = ckpt_io.load_checkpoint(path)
    trainer = ckpt["trainer_state_dict"]
    assert out["iter"] == 3 and out["enc_mode"] == "split"
    np.testing.assert_array_equal(out["latent_codes"],
                                  trainer["latent_codes"].numpy())
    back = from_jax_params(out["variables"])
    assert set(back) == set(trainer) - {"latent_codes"}
    for k, v in back.items():
        np.testing.assert_array_equal(v.numpy(), trainer[k].numpy(),
                                      err_msg=k)

    # merge_partial: everything but the latent codes into a fresh renderer
    renderer = build_renderer(common.resolve_config(TINY))
    merged, loaded, skipped = merge_partial(
        renderer.state_dict(), trainer, except_paths=("fc_alpha",))
    assert sorted(skipped) == ["model_coarse.fc_alpha.bias",
                               "model_coarse.fc_alpha.weight"]
    assert len(loaded) == len(renderer.state_dict()) - 2
    renderer.load_state_dict(merged)
    w0 = "model_coarse.layers_xyz.0.weight"
    assert torch.equal(renderer.state_dict()[w0], trainer[w0])
    merged, loaded, skipped = merge_partial(
        {"a": torch.zeros(2), "b": torch.zeros(3)},
        {"a": torch.ones(2), "b": torch.ones(4)})
    assert (loaded, skipped) == (["a"], ["b"])
    assert torch.equal(merged["a"], torch.ones(2))


def test_validation_obj_dump_and_preemption(run, tmp_path, monkeypatch):
    """With the cadences shortened (validate and save every 2 steps) a run
    writes the validation render, the skinning volume's .obj and interval
    checkpoints; a stop request (SIGTERM's flag) ends the run after the
    current step with a checkpoint of that step."""
    cfg_path = str(tmp_path / "fast.yml")
    text = open(TINY).read().replace("validate_every: 100",
                                     "validate_every: 2")
    open(cfg_path, "w").write(text.replace("save_every: 100",
                                           "save_every: 2"))
    logdir = str(tmp_path / "l3")
    st = cli.main(["--datadir", run["data"], "--logdir", logdir, "--config",
                   cfg_path, "--max-iters", "5", "--pretrain-iters", "0",
                   "--device", "cpu"])
    assert st["saved_steps"] == [2, 4, 5]
    assert len(st["val_psnr"]) == 2 and np.isfinite(st["val_psnr"]).all()
    names = os.listdir(logdir)
    assert "val_rgb_000002.png" in names and "val_rgb_000004.png" in names
    obj = obj_io.load_obj(os.path.join(logdir,
                                       "vis_motionWeightVol00002.obj"))
    assert obj["v"].shape == (8000, 3) and obj["vc"].shape == (8000, 3)
    assert 0.0 <= obj["vc"].min() and obj["vc"].max() <= 1.0

    preemption.reset()
    monkeypatch.setattr(cli, "should_stop", lambda: True)
    st = cli.main(["--datadir", run["data"], "--logdir",
                   str(tmp_path / "l4"), "--config", TINY, "--max-iters",
                   "5", "--pretrain-iters", "0", "--device", "cpu"])
    assert st["step"] == 1 and st["saved_steps"] == [1]


def test_checkpoint_manager_interval_and_retention(tmp_path):
    """save() writes on the interval or when forced, never twice for one
    step unless forced, keeps the newest max_to_keep files, and restore()
    gives the latest or a named step; a partly written file never carries
    a checkpoint's name."""
    mgr = ckpt_io.CheckpointManager(str(tmp_path / "c"), max_to_keep=2,
                                    save_interval_steps=10)
    assert mgr.latest_step() is None and mgr.restore() is None
    assert not mgr.save(3, {"iter": 3})
    assert mgr.save(10, {"iter": 10}) and not mgr.save(10, {"iter": -1})
    assert mgr.save(13, {"iter": 13}, force=True)
    assert mgr.save(20, {"iter": 20})
    assert mgr.all_steps() == [13, 20] and mgr.latest_step() == 20
    assert mgr.restore()["iter"] == 20 and mgr.restore(13)["iter"] == 13
    assert mgr.save(20, {"iter": 21}, force=True)
    assert mgr.restore()["iter"] == 21
    mgr.wait()
    assert sorted(os.listdir(mgr.directory)) == ["ckpt_00000013.pt",
                                                 "ckpt_00000020.pt"]
    assert ckpt_io.load_checkpoint(mgr.directory)["iter"] == 21


def test_small_utilities(tmp_path):
    """seed_everything returns the run's own generator (not the global
    one), to_device_batch moves the model inputs only, StepTimer keeps a
    rolling mean, MetricsWriter records scalars, OBJ files round-trip."""
    g1 = common.seed_everything(5, "cpu")
    a = torch.rand(3, generator=g1)
    g2 = common.seed_everything(5, "cpu")
    assert g2 is not torch.default_generator
    assert torch.equal(a, torch.rand(3, generator=g2))
    batch = {"mv_rays": np.zeros((1, 4, 12), np.float32),
             "dataset_idx": np.asarray([2]), "fidx": np.asarray([7])}
    out = common.to_device_batch(batch, "cpu")
    assert isinstance(out["mv_rays"], torch.Tensor)
    assert out["dataset_idx"].dtype == torch.int64
    assert isinstance(out["fidx"], np.ndarray)
    t = StepTimer(window=2)
    for _ in range(3):
        t.start()
        t.stop()
    assert len(t.times) == 2 and t.mean >= 0 and t.steps_per_sec > 0
    w = logging_util.MetricsWriter(str(tmp_path / "m"))
    w.scalar("train/loss", 0.5, 1)
    w.image("validation/x", np.zeros((2, 2, 3), np.float32), 1)
    w.close()
    assert os.listdir(str(tmp_path / "m"))
    assert len(logging_util.timestamp()) == 19
    v = np.random.RandomState(0).rand(5, 3).astype(np.float32)
    f = np.array([[1, 2, 3], [3, 4, 5]], np.int32)
    obj_io.save_obj(str(tmp_path / "a.obj"), v, f=f, vc=v)
    back = obj_io.load_obj(str(tmp_path / "a.obj"))
    np.testing.assert_allclose(back["v"], v, atol=1e-6)
    np.testing.assert_allclose(back["vc"], v, atol=1e-6)
    np.testing.assert_array_equal(back["f"], f)


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_training_modules_import_no_jax_flax_or_havatar_tpu():
    """Every module of the port, the training ones included, and the GPU
    kernel test import no jax, flax or havatar_tpu module (mind the shared
    ``havatar_tpu`` prefix: the match is on the top-level name)."""
    pkg = ROOT / "havatar_tpu_torch"
    files = sorted(pkg.rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "tests" / "test_torch_mlp_cuda.py"]
    for rel in ("cli/train_avatar.py", "train/losses.py", "train/lpips.py",
                "train/stage1.py", "ops/mlp.py", "checkpoints/io.py",
                "checkpoints/partial.py", "utils/logging_util.py",
                "utils/preemption.py", "utils/profiling.py",
                "utils/obj_io.py"):
        assert pkg / rel in files, rel
    bad = [f"{f.relative_to(ROOT)}: {mod}" for f in files
           for mod in _imports(f)
           if mod.split(".")[0] in ("jax", "jaxlib", "flax", "havatar_tpu",
                                    "optax", "orbax")]
    assert not bad, bad
