"""The port's native checkpoint: the reference's stage-2 ``.pt`` file.

A ``torch.save``d dict with the reference trainer's layout: ``nerf_render``
(the renderer's ``state_dict``: ``model_coarse.*``,
``headpose_skin_net.canonical_Wvolume.*`` and possibly ``latent_codes``),
``latent_codes`` [N, D], ``g_ema`` (and optionally ``g``, ``d``: StyleUNet
and discriminator ``state_dict``s) and ``iter``. The port's modules keep the
reference's parameter names, so loading is ``load_state_dict``, not a
conversion. Counterpart of ``havatar_tpu/checkpoints/convert.py:
load_torch_checkpoint, detect_nerf_enc_mode, convert_stage2_checkpoint``.

A training checkpoint (``stage2_training_checkpoint``) holds ``g`` and
``d`` too, and the three optimizers' states under the reference's names
(``nerf_optimizer``, ``g_optim``, ``d_optim``) for a resume; ``iter`` is
then the number of finished iterations.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Optional

import torch


def load_torch_checkpoint(path: str) -> Dict[str, Any]:
    return torch.load(path, map_location="cpu", weights_only=False)


def detect_nerf_enc_mode(sd: Mapping, prefix: str = "model_coarse") -> str:
    """The plane-encoder variant a renderer ``state_dict`` was built with:
    'split' has a second generator ``YZ_gen``, 'two_head' per-plane
    ``convs_head`` pyramids, 'shared_backbone' one double-width generator."""
    p = (prefix + ".") if prefix else ""
    if any(k.startswith(f"{p}YZ_gen.") for k in sd):
        return "split"
    if any(k.startswith(f"{p}XY_gen.convs_head.") for k in sd):
        return "two_head"
    return "shared_backbone"


def stage2_checkpoint(renderer: torch.nn.Module, g_ema: torch.nn.Module,
                      latent_codes: torch.Tensor,
                      iteration: int = 0) -> Dict[str, Any]:
    """The dict to ``torch.save`` for inference from these modules."""
    def cpu(sd):
        return {k: v.detach().cpu().clone() for k, v in sd.items()}

    return {"nerf_render": cpu(renderer.state_dict()),
            "latent_codes": latent_codes.detach().cpu().clone(),
            "g_ema": cpu(g_ema.state_dict()), "iter": int(iteration)}


def stage2_training_checkpoint(state, iteration: int) -> Dict[str, Any]:
    """The dict to save from a ``train/stage2.py:Stage2State`` after
    ``iteration`` finished iterations."""
    out = stage2_checkpoint(state.renderer, state.g_ema, state.latent_codes,
                            iteration)
    out.update({k: {n: v.detach().cpu().clone()
                    for n, v in m.state_dict().items()}
                for k, m in (("g", state.generator),
                             ("d", state.discriminator))})
    out.update({"nerf_optimizer": state.nerf_opt.state_dict(),
                "g_optim": state.g_opt.state_dict(),
                "d_optim": state.d_opt.state_dict(), "step": state.step})
    return out


def restore_stage2_training(state, ckpt: Mapping[str, Any]) -> int:
    """Load a training checkpoint dict into ``state`` in place; returns the
    iteration to resume at."""
    nerf = dict(ckpt["nerf_render"])
    nerf.pop("latent_codes", None)
    state.renderer.load_state_dict(nerf)
    state.generator.load_state_dict(ckpt["g"])
    state.discriminator.load_state_dict(ckpt["d"])
    state.g_ema.load_state_dict(ckpt["g_ema"])
    with torch.no_grad():
        state.latent_codes.copy_(ckpt["latent_codes"])
    state.nerf_opt.load_state_dict(ckpt["nerf_optimizer"])
    state.g_opt.load_state_dict(ckpt["g_optim"])
    state.d_opt.load_state_dict(ckpt["d_optim"])
    state.step = int(ckpt.get("step", ckpt["iter"]))
    return int(ckpt["iter"])


def load_stage2_checkpoint(path: str) -> Dict[str, Any]:
    """-> {"nerf_render": renderer state_dict without ``latent_codes``,
    "latent_codes": float tensor [N, D] or None, "g_ema": StyleUNet
    state_dict or None, "enc_mode": detected variant, "iter": int}."""
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory: an orbax checkpoint of the JAX "
            f"trainers. The port reads the reference's stage-2 .pt file "
            f"(torch.save of nerf_render / latent_codes / g_ema / iter)")
    ckpt = load_torch_checkpoint(path)
    nerf = dict(ckpt["nerf_render"])
    latent: Optional[torch.Tensor] = nerf.pop("latent_codes", None)
    if ckpt.get("latent_codes") is not None:
        latent = ckpt["latent_codes"]
    if latent is not None:
        latent = torch.as_tensor(latent).detach().float()
    return {"nerf_render": nerf, "latent_codes": latent,
            "g_ema": ckpt.get("g_ema"),
            "enc_mode": detect_nerf_enc_mode(nerf),
            "iter": int(ckpt.get("iter", -1))}
