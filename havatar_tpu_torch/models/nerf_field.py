"""Facial-model-conditioned double-plane NeRF field.

Port of ``havatar_tpu/models/nerf_field.py``: ``generate_planes`` in its
three ``enc_mode``s ('split': two PlaneGenerators, XY from the front
condition, ZY from the horizontally flipped left condition without its mask
channel ++ the right condition; 'shared_backbone': one double-width
PlaneGenerator over all three, planes split on channels; 'two_head': a
TwoHeadPlaneGenerator), the three ways a renderer feeds the five dense
layers:

* ``forward``: plane features ++ posenc through the dense chain (sh_deg =
  0), the exact renderer's field evaluation: five ``F.linear`` calls, or
  with ``use_fused_mlp`` the fused op ``ops/mlp.py:fused_mlp_chain``, whose
  forward and backward are one CUDA kernel each (JAX: ``use_pallas_mlp``);
* ``field_inputs``: that chain's input alone, [B, N, 2C + posenc] in the
  compute dtype and the reference's interleaved channel order, for the
  reduced-input march kernels (``march_params(dtype, permute=False)``);
* ``field_inputs_quad``: raw corner rows + posenc + corner weights for the
  quad march kernels (``march_params(dtype)``).

State_dict names follow the reference: ``XY_gen``, ``YZ_gen``,
``layers_xyz.{0,1}``, ``fc_alpha``, ``fc_rgbFeat``, ``fc_rgb``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from havatar_tpu_torch.models.generators import (
    PlaneGenerator,
    TwoHeadPlaneGenerator,
)
from havatar_tpu_torch.ops.boxwarp import BoxWarp
from havatar_tpu_torch.ops.embedding import positional_encoding, posenc_dim
from havatar_tpu_torch.ops.grid_sample import (
    grid_sample_2d_quad,
    sample_from_triplane,
)
from havatar_tpu_torch.ops.march import MarchParams, march_params
from havatar_tpu_torch.ops.mlp import fused_mlp_chain


class DoublePlaneNeRFField(nn.Module):
    def __init__(self, xyz_bounding=((-1.5, 1.5), (-1.6, 1.4), (-1.6, 1.2)),
                 num_encoding_fn_xyz: int = 8, latent_code_dim: int = 44,
                 plane_feat_dim: int = 64, plane_res: int = 128,
                 cond_res: int = 256, plane_middle_size: int = 16,
                 enc_mode: str = "split", hidden: int = 128,
                 feat_dim: int = 64,
                 compute_dtype: torch.dtype = torch.float32,
                 use_fused_mlp: bool = False):
        super().__init__()
        self.use_fused_mlp = use_fused_mlp
        self.num_encoding_fn_xyz = num_encoding_fn_xyz
        self.plane_feat_dim = plane_feat_dim
        self.enc_mode = enc_mode
        self.compute_dtype = compute_dtype
        gen = dict(out_size=plane_res, style_dim=latent_code_dim,
                   inp_size=cond_res, n_mlp=4, compute_dtype=compute_dtype)
        if enc_mode == "split":
            self.XY_gen = PlaneGenerator(
                out_ch=plane_feat_dim, middle_size=plane_middle_size,
                inp_ch=7, **gen)
            self.YZ_gen = PlaneGenerator(
                out_ch=plane_feat_dim, middle_size=plane_middle_size,
                inp_ch=13, **gen)
        elif enc_mode == "shared_backbone":
            self.XY_gen = PlaneGenerator(
                out_ch=2 * plane_feat_dim, middle_size=16, inp_ch=20, **gen)
        elif enc_mode == "two_head":
            self.XY_gen = TwoHeadPlaneGenerator(
                out_ch=plane_feat_dim, middle_size=8, split_size=32,
                inp_ch=(7, 13), **gen)
        else:
            raise ValueError(f"unknown enc_mode {enc_mode!r}")
        self.gridwarper = BoxWarp.from_bounds(xyz_bounding)
        fin = 2 * plane_feat_dim + posenc_dim(num_encoding_fn_xyz)
        self.layers_xyz = nn.ModuleList(
            [nn.Linear(fin, hidden), nn.Linear(hidden, hidden)])
        self.fc_alpha = nn.Linear(hidden, 1)
        self.fc_rgbFeat = nn.Linear(hidden, feat_dim)
        self.fc_rgb = nn.Linear(feat_dim, 3)

    def generate_planes(self, latents: torch.Tensor, cond_c: torch.Tensor,
                        front_cond: torch.Tensor, left_cond: torch.Tensor,
                        right_cond: torch.Tensor) -> torch.Tensor:
        """latents [B, L], cond_c [B, 12], conditions NHWC [B, S, S, 7]
        -> planes [2, B, R, R, C] (channels last: each bilinear corner is one
        contiguous row for the gather)."""
        z = torch.cat([latents, cond_c.reshape(latents.shape[0], -1)], -1)
        left = torch.flip(left_cond, dims=(2,))[..., :-1]

        def nchw(t):
            return t.permute(0, 3, 1, 2)

        side = nchw(torch.cat([left, right_cond], -1))
        if self.enc_mode == "shared_backbone":
            both = self.XY_gen(z, torch.cat([nchw(front_cond), side], 1))
            xy, zy = both.split(self.plane_feat_dim, dim=1)
        elif self.enc_mode == "two_head":
            xy, zy = self.XY_gen(z, nchw(front_cond), side)
        else:
            xy = self.XY_gen(z, nchw(front_cond))
            zy = self.YZ_gen(z, side)
        return torch.stack([xy, zy], 0).permute(0, 1, 3, 4, 2).contiguous()

    def sample_plane_features(self, pts: torch.Tensor,
                              planes: torch.Tensor) -> torch.Tensor:
        """[B, N, 3] x [2, B, R, R, C] -> [B, N, 2C] in the planes' dtype,
        channel order the reference's: feature index = 2c + p."""
        feats = sample_from_triplane(self.gridwarper(pts), planes)
        return feats.reshape(feats.shape[0], feats.shape[1], -1)

    def field_inputs(self, pts: torch.Tensor,
                     planes: torch.Tensor) -> torch.Tensor:
        """[B, N, 3] canonical points -> the dense chain's input (plane
        features ++ posenc) [B, N, 2C + posenc] in the compute dtype."""
        cdt = self.compute_dtype
        pe = positional_encoding(pts, self.num_encoding_fn_xyz)
        return torch.cat([self.sample_plane_features(pts, planes).to(cdt),
                          pe.to(cdt)], -1)

    def field_inputs_quad(self, pts: torch.Tensor, planes: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
        """[B, N, 3] canonical points -> (quads [B, N, 8C] in the planes'
        dtype: XY corner row ++ ZY corner row; aux [B, N, posenc + 8] f32:
        posenc ++ XY corner weights ++ ZY corner weights)."""
        warped = self.gridwarper(pts)
        rows_xy, w_xy = grid_sample_2d_quad(planes[0], warped[..., [0, 1]])
        rows_zy, w_zy = grid_sample_2d_quad(planes[1], warped[..., [2, 1]])
        pe = positional_encoding(pts, self.num_encoding_fn_xyz)
        return (torch.cat([rows_xy, rows_zy], -1),
                torch.cat([pe.float(), w_xy, w_zy], -1))

    def march_params(self, dtype: torch.dtype,
                     permute: bool = True) -> MarchParams:
        """The five dense layers as the march kernels take them: layer0 in
        block order for the quad kernels, ``permute=False`` for the kernels
        that take ``field_inputs``."""
        return march_params(self.layers_xyz, self.fc_rgbFeat, self.fc_alpha,
                            self.fc_rgb, self.plane_feat_dim,
                            posenc_dim(self.num_encoding_fn_xyz), dtype,
                            permute=permute)

    def forward(self, pts: torch.Tensor, viewdirs: Optional[torch.Tensor],
                planes: torch.Tensor) -> torch.Tensor:
        """[B, N, 3] canonical points -> radiance [B, N, 3 + feat + 1] f32
        (rgb, features, sigma). ``viewdirs`` is unused (sh_deg = 0). The
        dense layers run in the compute dtype."""
        cdt = self.compute_dtype

        def dense(lin, x):
            return F.linear(x, lin.weight.to(cdt), lin.bias.to(cdt))

        x = self.field_inputs(pts, planes)
        if self.use_fused_mlp:
            # the parameters go in as they are (not detached): the op's
            # backward fills their .grad
            B, N, fin = x.shape
            l0, l1 = self.layers_xyz
            out = fused_mlp_chain(
                x.reshape(B * N, fin), l0.weight, l0.bias, l1.weight,
                l1.bias, self.fc_rgbFeat.weight, self.fc_rgbFeat.bias,
                self.fc_alpha.weight, self.fc_alpha.bias, self.fc_rgb.weight,
                self.fc_rgb.bias)
            return out.reshape(B, N, -1)
        x = torch.relu(dense(self.layers_xyz[0], x))
        x = torch.relu(dense(self.layers_xyz[1], x))
        alpha = dense(self.fc_alpha, x).float()
        feat = dense(self.fc_rgbFeat, x)
        rgb = dense(self.fc_rgb, feat).float()
        return torch.cat([rgb, feat.float(), alpha], -1)
