"""The stage-2 steps on 2 CPU ranks (``gloo``) against one process, and the
two training CLIs under ``torch.distributed.run --nproc_per_node 2``.

``train/stage2.py:make_steps(mesh=...)`` splits the rays of the batch: each
rank renders its block and the feature image is all-gathered; the
generator, the discriminator and R1 run on every rank on the whole batch.
Every rank builds the same models (torch's default initialization from
seed 0) on tests/configs/tiny_hd.yml and reads the first batch of a
synthetic set, keeps its block of the rays, and runs a D step, an R1 step
and a G step with the optimizers' learning rates at 0, so that each step
sees the same weights and its raw gradients are left in ``.grad``
(``tests/torch_dist.py:stage2_worker``); rank 0 runs the same steps in one
process on the whole batch. Both get the same draws of the whole batch
(render noise with ``perturb`` and sigma noise on, the style codes, the
mixing layer and the StyledConvs' noise).

Bounds: as tests/test_torch_train_sharded.py's (summation order only):
every gradient tensor within 1e-5 of its largest entry (plus 1e-9), the
metrics within 1e-5 relative (plus 1e-6).
"""

import json
import os
import shutil
import sys

import pytest

sys.path.insert(0, os.path.dirname(__file__))
import torch_dist  # noqa: E402
from make_synthetic_dataset import make_dataset  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_HD = os.path.join(ROOT, "tests", "configs", "tiny_hd.yml")
GRAD_REL, GRAD_ATOL = 1e-5, 1e-9


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    from havatar_tpu_torch.cli.common import resolve_config
    root = tmp_path_factory.mktemp("s2")
    split = make_dataset(str(root / "data"), num_frames=2, img_res=64,
                         cond_res=64)
    cfg = resolve_config(TINY_HD)
    cfg.gan.batch = 1
    return torch_dist.run_ranks(torch_dist.stage2_worker, 2,
                                str(root / "run"),
                                json.loads(json.dumps(cfg)), split)


@pytest.mark.parametrize("step", torch_dist.STAGE2_GRADS)
def test_stage2_sharded_gradients_equal_one_process(ranks, step):
    """d: D's gradient of the D step; r1: of the R1 step; g and nerf: the
    G step's, of the generator and of the renderer and the latent codes
    (through the gathered 16 x 16 feature image). Each rank held 128 of the
    256 rays; its all-reduced gradients equal rank 0's (checksums), and
    rank 0's the one-process ones."""
    assert [out["rays"][:2] for out in ranks] == [(1, 128)] * 2
    errors = ranks[0]["errors"][step]
    held = 0
    for name, e in errors.items():
        if e is not None:
            assert e[0] <= GRAD_REL * e[1] + GRAD_ATOL, (step, name, e)
            held += 1
    assert held > 10
    assert ranks[1]["checksum"][step] == ranks[0]["checksum"][step]


def test_stage2_sharded_metrics_equal_one_process(ranks):
    """The D, R1 and G steps' metrics (losses, scores, PSNRs) on both ranks
    equal the one-process ones."""
    single = ranks[0]["single"]
    for out in ranks:
        for kind, want in single.items():
            assert set(out["metrics"][kind]) == set(want)
            for k, v in want.items():
                assert out["metrics"][kind][k] == pytest.approx(
                    v, rel=1e-5, abs=1e-6), (kind, k)


def test_training_clis_on_two_ranks(tmp_path):
    """``python -m torch.distributed.run --nproc_per_node 2 -m
    havatar_tpu_torch.cli.train_avatar ... --device cpu`` (a batch of one
    frame: its 64 rays split) and then ``cli.train_avatarHD`` from its
    checkpoint (gan.batch 2: the rays of the 16^2 renders split): each
    prints the mesh line once, rank 0 alone prints the step lines and
    writes the config, the metrics and the checkpoint."""
    split = make_dataset(str(tmp_path / "data"), num_frames=3, img_res=64,
                         cond_res=64)
    data = os.path.dirname(split)
    l1, l2 = str(tmp_path / "l1"), str(tmp_path / "l2")
    base = ["--datadir", data, "--config", TINY_HD, "--device", "cpu"]
    p1 = torch_dist.torchrun("havatar_tpu_torch.cli.train_avatar", base + [
        "--logdir", l1, "--max-iters", "2", "--pretrain-iters", "2",
        "--batch-size", "1"])
    assert p1.returncode == 0, p1.stderr[-3000:]
    lines = p1.stdout.splitlines()
    assert lines.count("data mesh: 2 devices; sharded keys: "
                       "['mv_rays', 'gt_color']") == 1, p1.stdout
    assert sum(ln.startswith("[TRAIN] Iter: ") for ln in lines) == 2
    assert lines.count("Done!") == 1
    assert os.listdir(os.path.join(l1, "checkpoints")) == [
        "ckpt_00000002.pt"]
    assert sum(n.startswith("config_") for n in os.listdir(l1)) == 1

    try:
        p2 = torch_dist.torchrun("havatar_tpu_torch.cli.train_avatarHD",
                                 base + ["--logdir", l2, "--max-iters", "1",
                                         "--ckpt",
                                         os.path.join(l1, "checkpoints")])
        assert p2.returncode == 0, p2.stderr[-3000:]
        lines = p2.stdout.splitlines()
        assert lines.count("data mesh: 2 devices; sharded keys: "
                           "['gt_color', 'mv_rays']") == 1, p2.stdout
        assert sum(ln.startswith("[HD] iter 0 ") for ln in lines) == 1
        assert lines.count("Done!") == 1
        assert os.listdir(os.path.join(l2, "checkpoints")) == [
            "ckpt_00000001.pt"]
    finally:
        # 0.7 and 1.1 GB of checkpoints: the suite's disk is shared
        shutil.rmtree(l1, ignore_errors=True)
        shutil.rmtree(l2, ignore_errors=True)
