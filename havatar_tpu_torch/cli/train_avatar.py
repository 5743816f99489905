"""Stage-1 NeRF avatar training CLI.

Usage:
  python -m havatar_tpu_torch.cli.train_avatar --datadir DATA --logdir LOGS \\
      [--config singleview_512_base.yml] [--ckpt RESUME.pt] [--max-iters N] \\
      [--pretrain-iters N] [--batch-size 2] [--lpips-weights F] [--device cpu]

Port of ``havatar_tpu/cli/train_avatar.py``. From a fresh log directory it
loads the config, builds the train and validation datasets and the renderer,
pretrains the skinning volume, then takes training steps (perturbed samples,
sigma noise, loss, backward, Adam at the decayed learning rate), validates
with a chunked full-image render, and writes metrics, the validation render
as a PNG, the skinning volume's ``.obj`` dump and stage-1 checkpoints
(``checkpoints/io.py``: every ``save_every`` steps and at the end of the
run). ``--ckpt`` (a checkpoint file, or a run's ``checkpoints`` directory
for its latest) resumes at the saved step and skips the pretraining. SIGTERM
or SIGINT saves a last checkpoint and ends the run.

It runs on the CUDA device unless ``--device`` names another (and raises
without CUDA). The patch-perceptual term needs converted LPIPS weights
(``--lpips-weights``, an ``.npz``); it is switched off when the file is
absent. The JAX CLI's multi-device branches are not ported.
"""

from __future__ import annotations

import argparse
import os
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from havatar_tpu_torch.checkpoints.io import (
    CheckpointManager,
    load_checkpoint,
    stage1_checkpoint,
)
from havatar_tpu_torch.cli.common import (
    resolve_config,
    seed_everything,
    to_device_batch,
)
from havatar_tpu_torch.data import (
    AvatarDataset,
    Loader,
    device_prefetch,
    infinite,
)
from havatar_tpu_torch.data.image_io import imwrite_rgb
from havatar_tpu_torch.device import resolve_device
from havatar_tpu_torch.train import stage1
from havatar_tpu_torch.train.losses import mse2psnr
from havatar_tpu_torch.train.lpips import load_lpips_file, lpips_loss
from havatar_tpu_torch.utils.logging_util import (
    MetricsWriter,
    create_code_snapshot,
    timestamp,
)
from havatar_tpu_torch.utils.obj_io import visualize_skin_volume
from havatar_tpu_torch.utils.preemption import (
    install as install_preemption,
    should_stop,
)
from havatar_tpu_torch.utils.profiling import StepTimer

TRAIN_KEYS = frozenset({
    "mv_rays", "gt_color", "inv_head_T", "dataset_idx", "front_render_cond",
    "left_render_cond", "right_render_cond"})


def restore_state(state: stage1.TrainState, ckpt: Dict[str, Any]) -> None:
    """Load a stage-1 checkpoint dict into ``state``, in place."""
    trainer = dict(ckpt["trainer_state_dict"])
    latent = trainer.pop("latent_codes")
    state.renderer.load_state_dict(trainer)
    with torch.no_grad():
        state.latent_codes.copy_(latent)
    state.optimizer.load_state_dict(ckpt["optimizer_state_dict"])
    state.step = int(ckpt["iter"])


def run_validation(state: stage1.TrainState, vb: Dict[str, Any], val_cfg,
                   writer: MetricsWriter, step: int,
                   lpips_params: Optional[Any] = None) -> float:
    """Render one full validation image in chunks, log its PSNR (and LPIPS
    with weights) and the fine, coarse, opacity, weight and error images.
    Returns the PSNR."""
    rays = vb["mv_rays"]
    R = rays.shape[1]
    chunk = min(R, 16384)
    while R % chunk:
        chunk //= 2
    with torch.no_grad():
        out = state.renderer.render_chunked(
            rays[..., :8], rays[..., 8:11],
            state.latent_codes[vb["dataset_idx"]], vb["inv_head_T"],
            vb["front_render_cond"], vb["left_render_cond"],
            vb["right_render_cond"], chunk_size=chunk,
            num_coarse=val_cfg.num_coarse, num_fine=val_cfg.num_fine,
            perturb=False)
    H = W = int(R ** 0.5)
    fine = out["rgb_fine"] is not None

    def img(t, c):
        return t[0].float().cpu().numpy().reshape(H, W, c)

    rgb = img((out["rgb_fine"] if fine else out["rgb_coarse"])[..., :3], 3)
    acc = img(out["acc_fine"] if fine else out["acc_coarse"], 1)
    target = img(vb["gt_color"], 3)
    psnr = float(mse2psnr(float(np.mean((rgb - target) ** 2))))
    writer.scalar("validation/psnr", psnr, step)
    if lpips_params is not None:
        dev = rays.device
        val_lpips = float(lpips_loss(
            lpips_params, torch.from_numpy(rgb)[None].to(dev),
            torch.from_numpy(target)[None].to(dev)))
        writer.scalar("validation/lpips", val_lpips, step)
    rgb_c = img(out["rgb_coarse"][..., :3], 3)
    images = {
        "rgb_fine": rgb, "img_target": target, "acc_fine": acc,
        "err_img": np.linalg.norm(rgb - target, axis=-1, keepdims=True),
        "rgb_coarse": rgb_c, "acc_coarse": img(out["acc_coarse"], 1),
        "weights_max": img(out["weights_max"], 1),
        "err_img_coarse": np.linalg.norm(rgb_c - target, axis=-1,
                                         keepdims=True)}
    for name, im in images.items():
        writer.image(f"validation/{name}", np.clip(im, 0, 1), step)
    imwrite_rgb(os.path.join(writer.logdir, f"val_rgb_{step:06d}.png"),
                (np.clip(rgb, 0, 1) * 255.0 + 0.5).astype(np.uint8))
    print(f"[VAL] iter {step} PSNR {psnr:.4f}", flush=True)
    return psnr


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--logdir", type=str, required=True)
    p.add_argument("--datadir", type=str, required=True)
    p.add_argument("--config", type=str, default="singleview_512_base.yml")
    p.add_argument("--ckpt", type=str, default="")
    p.add_argument("--lpips-weights", type=str, default="lpips_vgg.npz",
                   help="converted LPIPS-VGG weights (.npz); the perceptual "
                        "loss terms are on when the file exists")
    p.add_argument("--max-iters", type=int, default=0,
                   help="override cfg.experiment.train_iters (short runs)")
    p.add_argument("--pretrain-iters", type=int, default=3000,
                   help="skinning-volume pretrain iterations (0 to skip)")
    p.add_argument("--batch-size", type=int, default=2,
                   help="frames per step")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: CUDA, an error without it)")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    install_preemption()
    cfg = resolve_config(args.config)
    rng = seed_everything(cfg.experiment.randomseed, device)

    os.makedirs(args.logdir, exist_ok=True)
    writer = MetricsWriter(args.logdir)
    with open(os.path.join(args.logdir, f"config_{timestamp()}.yml"),
              "w") as f:
        f.write(cfg.dump())
    create_code_snapshot(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        os.path.join(args.logdir, f"code_bk_{timestamp()}.tar.gz"))

    split = os.path.join(args.datadir, "sv_v31_all.json")
    train_ds = AvatarDataset(split, "train", cfg,
                             down_sample=cfg.dataset.down_sample)
    train_loader = Loader(train_ds, batch_size=args.batch_size,
                          seed=cfg.experiment.randomseed)
    state = stage1.init_state(cfg, len(train_ds), device)

    ckpt_mgr = CheckpointManager(os.path.join(args.logdir, "checkpoints"),
                                 save_interval_steps=cfg.experiment.save_every)
    pretrain_hist: List[float] = []
    ckpt = load_checkpoint(args.ckpt) if args.ckpt else None
    if ckpt is not None:
        restore_state(state, ckpt)
        print(f"resumed from step {state.step}")
    elif args.pretrain_iters > 0:
        pretrain_hist = stage1.pretrain_skinning(
            state.renderer, rng, cfg.models.coarse.Head_bounding,
            num_iter=args.pretrain_iters)
        print(f"skinning pretrain done, BCE {pretrain_hist[0]:.4f} -> "
              f"{pretrain_hist[-1]:.4f}")
    start_step = state.step

    lpips_params = load_lpips_file(args.lpips_weights, device)
    if cfg.experiment.get("patch_rgb", False) and lpips_params is None:
        print("note: patch_rgb is on but no LPIPS weights found at "
              f"{args.lpips_weights}; the patch perceptual term is disabled")
    train_step = stage1.make_train_step(state, cfg, lpips_params)

    # validation: full images at native resolution
    val_ds = AvatarDataset(split, "val", cfg, down_sample=1.0)
    val_iter = infinite(Loader(val_ds, batch_size=1, shuffle=True,
                               num_workers=1,
                               seed=cfg.experiment.randomseed + 1))

    max_iters = args.max_iters or cfg.experiment.train_iters
    timer = StepTimer(device=device)
    data_iter = device_prefetch(infinite(train_loader), size=2,
                                device=device, keys=TRAIN_KEYS)
    losses: List[float] = []
    val_psnr: List[float] = []
    saved: List[int] = []

    def save(force: bool = False) -> None:
        tree = stage1_checkpoint(state.renderer, state.latent_codes,
                                 state.optimizer, state.step,
                                 loss=losses[-1] if losses else float("nan"))
        if ckpt_mgr.save(state.step, tree, force=force):
            saved.append(state.step)

    for i in range(start_step, max_iters):
        batch = next(data_iter)
        timed = i % cfg.experiment.print_every == 0
        if timed:       # the timer synchronizes the device: printed steps only
            timer.start()
        metrics = train_step(batch, rng)
        if timed:
            timer.stop()
            losses.append(float(metrics["loss"]))
            print(f"[TRAIN] Iter: {i} Loss: {losses[-1]:.6f} "
                  f"PSNR: {float(metrics['psnr']):.4f} "
                  f"s/iter: {timer.mean:.3f}", flush=True)
            for k, v in metrics.items():
                writer.scalar(f"train/{k}", float(v), i)
        if i > start_step and i % cfg.experiment.validate_every == 0:
            vb = to_device_batch(next(val_iter), device)
            val_psnr.append(run_validation(state, vb, cfg.nerf.validation,
                                           writer, i, lpips_params))
        if i > start_step and i % cfg.experiment.save_every == 0:
            visualize_skin_volume(
                state.renderer,
                os.path.join(args.logdir, f"vis_motionWeightVol{i:05d}.obj"))
        save()
        if should_stop():
            print(f"preempted at iter {i}; saving a checkpoint", flush=True)
            break
    if state.step > start_step and state.step not in saved:
        save(force=True)    # the run's last state, whatever the interval

    ckpt_mgr.wait()
    writer.close()
    print("Done!")
    return {"start_step": start_step, "step": state.step, "losses": losses,
            "pretrain_bce": pretrain_hist, "val_psnr": val_psnr,
            "saved_steps": saved, "s_per_iter": timer.mean,
            "checkpoint_dir": ckpt_mgr.directory}


if __name__ == "__main__":
    main()
