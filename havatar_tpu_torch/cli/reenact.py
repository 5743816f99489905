"""Reenactment inference CLI: a checkpoint and a driving split to PNG frames.

Usage:
  python -m havatar_tpu_torch.cli.reenact --ckpt CKPT.pt --savedir OUT \\
      --split SPLIT.json [--config singleview_512_HD_base.yml] \\
      [--precision auto|fast|exact] [--gated --coarse 16] [--device cpu]

``--ckpt`` is a stage-2 ``.pt`` file in the reference's layout
(``checkpoints/stage2.py``). Port of ``havatar_tpu/cli/reenact.py``; where
that CLI picks its platform from ``HAVATAR_PLATFORM``, this one takes
``--device`` (default: the CUDA device, and it raises without one).

On N GPUs: ``torchrun --nproc_per_node N -m havatar_tpu_torch.cli.reenact
...`` (``--device cpu``: N CPU processes on ``gloo``) splits each frame's
rays over the ranks (``infer/serving.py``); rank 0 writes the PNGs and
prints the stats.
"""

from __future__ import annotations

import argparse
import json
from typing import Any, Dict, List, Optional

from havatar_tpu_torch.checkpoints.stage2 import load_stage2_checkpoint
from havatar_tpu_torch.cli.common import resolve_config, seed_everything
from havatar_tpu_torch.infer.reenact import run_reenactment
from havatar_tpu_torch.parallel import comm


def load_inference_weights(ckpt_path: str):
    """-> (renderer state_dict, latent_codes, g_ema state_dict, enc_mode)."""
    ckpt = load_stage2_checkpoint(ckpt_path)
    if ckpt["latent_codes"] is None:
        raise ValueError(f"{ckpt_path} lacks latent_codes")
    if ckpt["g_ema"] is None:
        raise ValueError(f"{ckpt_path} lacks g_ema")
    return (ckpt["nerf_render"], ckpt["latent_codes"], ckpt["g_ema"],
            ckpt["enc_mode"])


def main(argv: Optional[List[str]] = None) -> Optional[Dict[str, Any]]:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config", type=str, default="singleview_512_HD_base.yml")
    p.add_argument("--ckpt", type=str, required=True)
    p.add_argument("--savedir", type=str, default="./renders/")
    p.add_argument("--split", type=str, required=True)
    p.add_argument("--max-frames", type=int, default=0)
    p.add_argument("--precision", type=str, default="auto",
                   choices=["auto", "fast", "exact"],
                   help="fast: bf16 + the fused CUDA march kernels (auto on "
                        "CUDA); exact: the float32 path that the parity "
                        "tests hold to the JAX package (auto on the CPU)")
    p.add_argument("--gated", action="store_true",
                   help="occupancy-gated sampling: tighten each ray's "
                        "near/far to the avatar's box and march --coarse "
                        "samples in the occupied chord; not bit-identical "
                        "to the blind schedule")
    p.add_argument("--coarse", type=int, default=0,
                   help="coarse samples a ray (0: the config's value); "
                        "with --gated a smaller count such as 16 or 32")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: CUDA, an error without it)")
    args = p.parse_args(argv)
    with comm.process_group(args.device):
        return reenact(args)


def reenact(args) -> Optional[Dict[str, Any]]:
    """The run ``main``'s arguments describe; returns its stats on rank 0
    (None on the others)."""
    cfg = resolve_config(args.config)
    seed_everything(cfg.experiment.randomseed)

    variables, latent_codes, g_ema, ckpt_enc = load_inference_weights(
        args.ckpt)
    cfg_enc = cfg.models.coarse.get("enc_mode", "split")
    if ckpt_enc != cfg_enc:
        # build the field the CHECKPOINT holds: the config's default would
        # not match its keys
        if comm.is_primary():
            print(f"checkpoint enc_mode {ckpt_enc!r} overrides config "
                  f"{cfg_enc!r}")
        cfg.models.coarse.enc_mode = ckpt_enc
    stats = run_reenactment(
        cfg, args.split, args.savedir, variables, latent_codes, g_ema,
        seed=cfg.experiment.randomseed,
        max_frames=args.max_frames or None, precision=args.precision,
        gated=args.gated, num_coarse=args.coarse or None,
        device=args.device)
    if stats is not None:
        print(json.dumps(stats))
        print("Done!")
    return stats


if __name__ == "__main__":
    main()
