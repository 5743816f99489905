"""Stage-2 HD (NeRF + StyleUNet GAN) training CLI.

Usage:
  python -m havatar_tpu_torch.cli.train_avatarHD --datadir DATA --logdir LOGS \\
      --ckpt STAGE1.pt [--config singleview_512_HD_base.yml] [--max-iters N] \\
      [--fast-step] [--fused-mlp] [--fused-quad] [--bf16] [--sorted-scatter] \\
      [--turbo] [--lpips-weights F] [--device cpu]
  ... --ckpt STAGE2.pt --continue-training       (resume a stage-2 run)

Port of ``havatar_tpu/cli/train_avatarHD.py``. It loads the config, builds
the full-image training set (128^2 rays, 512^2 targets), the renderer, the
StyleUNet generator and the wavelet discriminator, warm-starts the NeRF
side from a stage-1 checkpoint (the port's own ``.pt``, or a run's
``checkpoints`` directory for its latest) or resumes everything from a
stage-2 one with ``--continue-training``, then iterates: a D step, the R1
step every ``gan.d_reg_every`` iterations from 0, and a G step (or, with
``--fast-step``, R1 then one fused D + G step on a shared render). Every
``print_every`` iterations it logs the metrics, every ``validate_every``
(after the first) it writes the g_ema sample grid (sample | nearest-upsampled
render | target), and it saves stage-2 checkpoints in the reference's layout
(``checkpoints/stage2.py``) every ``save_every`` iterations and at the end;
SIGTERM or SIGINT saves one and ends the run.

It runs on the CUDA device unless ``--device`` names another (and raises
without CUDA). There are no LPIPS weights in the repository, so the G step's
0.1 * LPIPS term is off unless ``--lpips-weights`` names a converted file,
and the run says so.

On N GPUs: ``torchrun --nproc_per_node N -m
havatar_tpu_torch.cli.train_avatarHD ...`` (``--device cpu``: N CPU
processes on ``gloo``), as ``cli/train_avatar.py``: every rank reads the
same batches and keeps its block of the rays (``train/stage2.py`` says why
never the frames), the state is broadcast from rank 0 after its warm start
or resume, the G and D gradients are averaged, and only rank 0 prints
``[HD]`` lines and writes metrics, sample grids and checkpoints (every rank
renders its block of a sample grid's rays).
"""

from __future__ import annotations

import argparse
import os
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from havatar_tpu_torch.checkpoints.io import CheckpointManager, load_checkpoint
from havatar_tpu_torch.checkpoints.stage2 import (
    restore_stage2_training,
    stage2_training_checkpoint,
)
from havatar_tpu_torch.cli.common import (
    BATCH_KEYS,
    any_rank,
    resolve_config,
    seed_everything,
)
from havatar_tpu_torch.data import AvatarDataset, Loader, device_prefetch, infinite
from havatar_tpu_torch.data.image_io import imwrite_rgb
from havatar_tpu_torch.device import resolve_device
from havatar_tpu_torch.parallel import comm, make_mesh, ray_sharding, replicated
from havatar_tpu_torch.parallel.mesh import RAY_AXIS_KEYS, sharded_keys
from havatar_tpu_torch.train import stage2
from havatar_tpu_torch.train.lpips import load_lpips_file
from havatar_tpu_torch.utils.logging_util import MetricsWriter
from havatar_tpu_torch.utils.preemption import (
    install as install_preemption,
    should_stop,
)
from havatar_tpu_torch.utils.profiling import StepTimer

PRETRAINED_GAN = "pretrained_models/img_translation.ckpt"


def prepare_batch(batch: Dict[str, Any], gen_size: int,
                  render_size: int) -> Dict[str, Any]:
    """The loader's flat arrays as the stage-2 image tensors: the 512^2
    target ``gt_hr_img`` [B, 512, 512, 3] and the render's mask target
    ``gt_lr_mask`` [B, 128, 128, 1] (the rays' last column)."""
    B = batch["mv_rays"].shape[0]
    out = dict(batch)
    out["gt_hr_img"] = batch["gt_color"].reshape(B, gen_size, gen_size, 3)
    out["gt_lr_mask"] = batch["mv_rays"][..., -1:].reshape(
        B, render_size, render_size, 1)
    return out


def warm_start(state: stage2.Stage2State, ckpt: Dict[str, Any],
               continue_training: bool, device) -> int:
    """Load ``--ckpt``'s dict into ``state``; returns the iteration to
    start at. A stage-1 checkpoint fills the NeRF side (and the generator
    and discriminator from the reference's pretrained translation network,
    if ``PRETRAINED_GAN`` exists); a stage-2 one, with
    ``continue_training``, everything."""
    stage1 = "trainer_state_dict" in ckpt
    if continue_training:
        if stage1:
            raise SystemExit("--continue-training needs a stage-2 checkpoint;"
                             " this one is stage 1 (warm-start without it)")
        return restore_stage2_training(state, ckpt)
    if not stage1:
        raise SystemExit("this is a stage-2 checkpoint: pass "
                         "--continue-training to resume from it")
    nerf = dict(ckpt["trainer_state_dict"])
    latent = nerf.pop("latent_codes", None)
    state.renderer.load_state_dict(nerf)
    if latent is not None:
        with torch.no_grad():
            state.latent_codes.copy_(latent)
    if os.path.exists(PRETRAINED_GAN):
        pre = torch.load(PRETRAINED_GAN, map_location=device,
                         weights_only=False)
        state.generator.load_state_dict(pre["g"])
        state.discriminator.load_state_dict(pre["d"])
        state.g_ema.load_state_dict(pre["g_ema"])
    return 0


def save_sample_grid(state: stage2.Stage2State, cfg, batch: Dict[str, Any],
                     path: str, mesh=None) -> None:
    """g_ema's image of a deterministic render (zero style, no noise) beside
    the render's colour upsampled by repetition and the target, one row an
    item, as a PNG. With ``mesh`` every rank renders its block of the
    rays and rank 0 writes the whole grid."""
    val = cfg.nerf.validation
    gen_size = cfg.models.StyleUnet.out_size
    up = gen_size // cfg.models.StyleUnet.inp_size
    with torch.no_grad():
        render, _ = stage2.render_image(
            state.renderer, state.latent_codes, batch, val.num_coarse,
            val.num_fine, mesh=mesh)
        if not comm.is_primary():
            return
        style = torch.zeros(render.shape[0], cfg.gan.latent,
                            device=render.device)
        sample = state.g_ema(style, stage2.nchw(render[..., 3:]))
        lr_up = render[..., :3].repeat_interleave(up, 1).repeat_interleave(
            up, 2)
        grid = torch.cat([sample.permute(0, 2, 3, 1), lr_up,
                          batch["gt_hr_img"]], 2)
    grid = (grid.clamp(0, 1) * 255).to(torch.uint8).cpu().numpy()
    imwrite_rgb(path, grid.reshape(-1, grid.shape[2], 3))


def main(argv: Optional[List[str]] = None) -> Optional[Dict[str, Any]]:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--logdir", type=str, required=True)
    p.add_argument("--datadir", type=str, required=True)
    p.add_argument("--config", type=str, default="singleview_512_HD_base.yml")
    p.add_argument("--ckpt", type=str, default="",
                   help="a stage-1 checkpoint to warm-start the NeRF from, "
                        "or with --continue-training a stage-2 one (a file, "
                        "or a run's checkpoints directory for its latest)")
    p.add_argument("--lpips-weights", type=str, default="lpips_vgg.npz",
                   help="converted LPIPS-VGG weights (.npz); the G step's "
                        "perceptual term is on when the file exists")
    p.add_argument("--continue-training", action="store_true")
    p.add_argument("--max-iters", type=int, default=0,
                   help="override gan.iter (short runs)")
    p.add_argument("--fast-step", action="store_true",
                   help="one render a iteration shared by the D and G "
                        "losses (D + G in one step); differs from the "
                        "reference's alternating update in two ways: one "
                        "draw for both renders, and G plays against the "
                        "pre-update D")
    p.add_argument("--fused-mlp", action="store_true",
                   help="the field's dense chain as the fused op of "
                        "ops/mlp.py (one CUDA kernel forward, one backward)")
    p.add_argument("--fused-quad", action="store_true",
                   help="gather, corner reduction and dense chain as the "
                        "fused op of ops/mlp_quad.py (one CUDA kernel "
                        "forward, one backward, a batch item each); takes "
                        "precedence over --fused-mlp")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 NeRF compute (plane generators, planes, "
                        "the field's products; float32 accumulation, "
                        "geometry and GAN nets)")
    p.add_argument("--sorted-scatter", action="store_true",
                   help="sort the fused quad op's plane-gradient rows by "
                        "destination before index_add_; touches only that "
                        "splat of the plain path (with --fused-quad on the "
                        "CPU): the CUDA kernel splats in the kernel and has "
                        "no scatter order to choose")
    p.add_argument("--turbo", action="store_true",
                   help="--fast-step --fused-quad --bf16 together")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: CUDA, an error without it)")
    args = p.parse_args(argv)
    if args.turbo:
        args.fast_step = args.fused_quad = args.bf16 = True
    with comm.process_group(args.device):
        return train(args)


def train(args) -> Optional[Dict[str, Any]]:
    """The run ``main``'s arguments describe; returns its record on rank 0
    (None on the others)."""
    device = resolve_device(args.device)
    primary = comm.is_primary()
    install_preemption()
    cfg = resolve_config(args.config)
    if args.fused_mlp:
        cfg.models.use_pallas_mlp = True
    if args.fused_quad:
        cfg.models.use_pallas_mlp_quad = True
    if args.bf16:
        cfg.models.compute_dtype = "bfloat16"
    rng = seed_everything(cfg.experiment.randomseed, device)
    render_size = cfg.models.StyleUnet.inp_size
    gen_size = cfg.models.StyleUnet.out_size

    writer = None
    if primary:
        writer = MetricsWriter(args.logdir)
        with open(os.path.join(args.logdir, "config.yml"), "w") as f:
            f.write(cfg.dump())

    split = os.path.join(args.datadir, "sv_v31_all.json")
    train_ds = AvatarDataset(split, "train", cfg,
                             down_sample=cfg.dataset.down_sample,
                             full_image=True)
    loader = Loader(train_ds, batch_size=cfg.gan.batch,
                    seed=cfg.experiment.randomseed)
    state = stage2.init_state(cfg, len(train_ds), device,
                              stage2.build_models(
                                  cfg, sorted_scatter=args.sorted_scatter))
    start = 0
    ckpt = load_checkpoint(args.ckpt) if args.ckpt else None
    if ckpt is not None:
        start = warm_start(state, ckpt, args.continue_training, device)
        if primary:
            print(f"{'resumed' if args.continue_training else 'warm-started'}"
                  f" from {args.ckpt} at iteration {start}", flush=True)

    lpips_params = load_lpips_file(args.lpips_weights, device)
    if lpips_params is None and primary:
        print("=" * 70 + "\nWARNING: no LPIPS weights at "
              f"'{args.lpips_weights}': the 0.1*LPIPS perceptual term of the "
              "G step is DISABLED.\n" + "=" * 70, flush=True)
    mesh, shardings = None, None
    if comm.get_world_size() > 1:
        mesh = make_mesh(("data",), device)
        shardings = {k: (ray_sharding if k in RAY_AXIS_KEYS
                         else replicated)(mesh) for k in sorted(BATCH_KEYS)}
        comm.broadcast_(
            [state.latent_codes]
            + [t for m in (state.renderer, state.generator,
                           state.discriminator, state.g_ema)
               for t in m.state_dict().values()])
        if primary:
            print(f"data mesh: {mesh.size()} devices; sharded keys: "
                  f"{sharded_keys(shardings)}", flush=True)
    d_step, r1_step, g_step, dg_step = stage2.make_steps(
        state, cfg, lpips_params, mesh)

    ckpt_mgr = None
    sample_dir = os.path.join(args.logdir, "sample")
    if primary:
        ckpt_mgr = CheckpointManager(
            os.path.join(args.logdir, "checkpoints"),
            save_interval_steps=cfg.experiment.save_every)
        os.makedirs(sample_dir, exist_ok=True)

    max_iters = args.max_iters or cfg.gan.iter
    timer = StepTimer(device=device)
    data_iter = device_prefetch(
        (prepare_batch(b, gen_size, render_size) for b in infinite(loader)),
        size=2, device=device, keys=BATCH_KEYS, sharding=shardings)
    history: Dict[str, List[float]] = {"iter": [], "psnr": [], "d": [],
                                       "g": [], "r1": []}
    samples: List[int] = []
    saved: List[int] = []

    def save(done: int, force: bool = False) -> None:
        if primary and ckpt_mgr.save(
                done, stage2_training_checkpoint(state, done), force=force):
            saved.append(done)

    done = start
    for i in range(start, max_iters):
        batch = next(data_iter)
        timed = i % cfg.experiment.print_every == 0
        if timed:       # the timer synchronizes the device: printed steps only
            timer.start()
        r1 = i % cfg.gan.d_reg_every == 0
        if args.fast_step:
            r1_metrics = r1_step(batch) if r1 else {}
            g_metrics = dg_step(batch, rng)
            d_metrics = {k: g_metrics[k] for k in
                         ("d", "real_score", "fake_score")}
            d_metrics.update(r1_metrics)
        else:
            d_metrics = d_step(batch, rng)
            if r1:
                d_metrics.update(r1_step(batch))
            g_metrics = g_step(batch, rng)
        done = i + 1
        if timed:
            timer.stop()
            row = {"psnr": float(g_metrics["psnr"]),
                   "d": float(d_metrics["d"]), "g": float(g_metrics["g"]),
                   "r1": float(d_metrics.get("r1", float("nan")))}
            history["iter"].append(i)
            for k, v in row.items():
                history[k].append(v)
            if primary:
                print(f"[HD] iter {i} PSNR {row['psnr']:.3f} "
                      f"d {row['d']:.4f} g {row['g']:.4f} "
                      f"s/iter {timer.mean:.3f}", flush=True)
                for k, v in {**d_metrics, **g_metrics}.items():
                    writer.scalar(f"train/{k}", float(v), i)
        if i > start and i % cfg.experiment.validate_every == 0:
            save_sample_grid(state, cfg, batch,
                             os.path.join(sample_dir, f"{i:06d}.png"),
                             mesh)
            samples.append(i)
        save(done)
        if any_rank(should_stop(), device):
            print(f"preempted at iter {i}; saving a checkpoint", flush=True)
            break
    if done > start and done not in saved:
        save(done, force=True)    # the run's last state, whatever the interval

    comm.synchronize()
    if not primary:
        return None
    ckpt_mgr.wait()
    writer.close()
    print("Done!")
    return {"start": start, "iter": done, "history": history,
            "samples": samples, "saved": saved, "s_per_iter": timer.mean,
            "checkpoint_dir": ckpt_mgr.directory}


if __name__ == "__main__":
    main()
