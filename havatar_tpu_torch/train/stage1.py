"""Stage-1 NeRF training: so far only ``build_renderer``.

Port of ``havatar_tpu/train/stage1.py:build_renderer``, the one place that
turns a config into an ``AvatarRenderer``; inference uses it too. The
trainer itself is not ported yet.
"""

from __future__ import annotations

import torch

from havatar_tpu_torch.models.renderer import AvatarRenderer

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def build_renderer(cfg, **overrides) -> AvatarRenderer:
    """The renderer a config describes: the exact path, skinning volume
    sampled in float32. ``overrides`` replace constructor arguments (the
    inference loop passes ``compute_dtype``, ``skin_compute_dtype`` and
    the march switches for its fast mode, where the JAX package clones the
    module)."""
    coarse = cfg.models.coarse
    kw = dict(
        xyz_bounding=tuple(tuple(b) for b in coarse.XYZ_bounding),
        latent_code_dim=cfg.experiment.latent_code_dim,
        cond_pose=cfg.experiment.cond_pose,
        num_encoding_fn_xyz=coarse.get("num_encoding_fn_xyz", 8),
        plane_feat_dim=coarse.get("plane_feat_dim", 64),
        plane_res=coarse.get("plane_res", 128),
        plane_middle_size=coarse.get("plane_middle_size", 16),
        enc_mode=coarse.get("enc_mode", "split"),
        skin_vol_res=coarse.get("skin_vol_res", 64),
        feat_dim=cfg.models.StyleUnet.inp_ch,
        compute_dtype=_DTYPES[cfg.models.get("compute_dtype", "float32")],
        skin_compute_dtype=_DTYPES[cfg.models.get("skin_compute_dtype",
                                                  "float32")],
        render_size=cfg.models.StyleUnet.inp_size,
        cond_res=cfg.dataset.cond_render_res,
    )
    kw.update(overrides)
    return AvatarRenderer(**kw)
