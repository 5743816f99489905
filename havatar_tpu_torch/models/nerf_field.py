"""Facial-model-conditioned double-plane NeRF field, 'split' enc_mode.

Port of ``havatar_tpu/models/nerf_field.py`` as the fused march uses it:
``generate_planes`` (two PlaneGenerators: XY from the front condition, ZY
from the horizontally flipped left condition without its mask channel ++ the
right condition), ``field_inputs_quad`` (raw corner rows + posenc + corner
weights for the march kernels) and the five dense layers, whose weights the
kernels take through ``march_params``.

State_dict names follow the reference: ``XY_gen``, ``YZ_gen``,
``layers_xyz.{0,1}``, ``fc_alpha``, ``fc_rgbFeat``, ``fc_rgb``.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from havatar_tpu_torch.models.generators import PlaneGenerator
from havatar_tpu_torch.ops.boxwarp import BoxWarp
from havatar_tpu_torch.ops.embedding import positional_encoding, posenc_dim
from havatar_tpu_torch.ops.grid_sample import grid_sample_2d_quad
from havatar_tpu_torch.ops.march import MarchParams, march_params


class DoublePlaneNeRFField(nn.Module):
    def __init__(self, xyz_bounding=((-1.5, 1.5), (-1.6, 1.4), (-1.6, 1.2)),
                 num_encoding_fn_xyz: int = 8, latent_code_dim: int = 44,
                 plane_feat_dim: int = 64, plane_res: int = 128,
                 cond_res: int = 256, plane_middle_size: int = 16,
                 hidden: int = 128, feat_dim: int = 64,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_encoding_fn_xyz = num_encoding_fn_xyz
        self.plane_feat_dim = plane_feat_dim
        gen = dict(out_ch=plane_feat_dim, out_size=plane_res,
                   style_dim=latent_code_dim, middle_size=plane_middle_size,
                   inp_size=cond_res, n_mlp=4, compute_dtype=compute_dtype)
        self.XY_gen = PlaneGenerator(inp_ch=7, **gen)
        self.YZ_gen = PlaneGenerator(inp_ch=13, **gen)
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

        xy = self.XY_gen(z, nchw(front_cond))
        zy = self.YZ_gen(z, nchw(torch.cat([left, right_cond], -1)))
        return torch.stack([xy, zy], 0).permute(0, 1, 3, 4, 2).contiguous()

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

    def march_params(self, dtype: torch.dtype) -> MarchParams:
        """The five dense layers as the march kernels take them."""
        return march_params(self.layers_xyz, self.fc_rgbFeat, self.fc_alpha,
                            self.fc_rgb, self.plane_feat_dim,
                            posenc_dim(self.num_encoding_fn_xyz), dtype)
