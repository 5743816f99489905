"""The double-plane NeRF field, plain PyTorch.

A frozen copy of the field of ``havatar_tpu_torch/models/nerf_field.py``
(itself the reference's ``DoublePlaneNeRF``) with the plain path only:
two plane generators (``enc_mode`` "split": XY from the front condition,
ZY from the horizontally flipped left condition without its mask channel ++
the right condition), bilinear plane sampling with zeros padding and five
``F.linear`` layers. No fused op, no kernel: this is what the kernels of the
program under test compute.

State_dict names follow the reference: ``XY_gen``, ``YZ_gen``,
``layers_xyz.{0,1}``, ``fc_alpha``, ``fc_rgbFeat``, ``fc_rgb``.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .boxwarp import BoxWarp
from .embedding import positional_encoding, posenc_dim
from .generators import PlaneGenerator
from .grid_sample import sample_from_triplane


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
        self.compute_dtype = compute_dtype
        gen = dict(out_size=plane_res, style_dim=latent_code_dim,
                   inp_size=cond_res, n_mlp=4, compute_dtype=compute_dtype,
                   out_ch=plane_feat_dim, middle_size=plane_middle_size)
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
        -> planes [2, B, R, R, C], channels last."""
        z = torch.cat([latents, cond_c.reshape(latents.shape[0], -1)], -1)
        left = torch.flip(left_cond, dims=(2,))[..., :-1]

        def nchw(t):
            return t.permute(0, 3, 1, 2)

        xy = self.XY_gen(z, nchw(front_cond))
        zy = self.YZ_gen(z, nchw(torch.cat([left, right_cond], -1)))
        return torch.stack([xy, zy], 0).permute(0, 1, 3, 4, 2).contiguous()

    def field_inputs(self, pts: torch.Tensor,
                     planes: torch.Tensor) -> torch.Tensor:
        """[B, N, 3] canonical points -> plane features (feature index
        2c + p) ++ posenc, [B, N, 2C + posenc] in the compute dtype."""
        cdt = self.compute_dtype
        feats = sample_from_triplane(self.gridwarper(pts), planes)
        feats = feats.reshape(feats.shape[0], feats.shape[1], -1)
        pe = positional_encoding(pts, self.num_encoding_fn_xyz)
        return torch.cat([feats.to(cdt), pe.to(cdt)], -1)

    def forward(self, pts: torch.Tensor, planes: torch.Tensor
                ) -> torch.Tensor:
        """[B, N, 3] canonical points -> radiance [B, N, 3 + feat + 1] f32
        (rgb, features, sigma)."""
        cdt = self.compute_dtype

        def dense(lin, x):
            return F.linear(x, lin.weight.to(cdt), lin.bias.to(cdt))

        x = self.field_inputs(pts, planes)
        x = torch.relu(dense(self.layers_xyz[0], x))
        x = torch.relu(dense(self.layers_xyz[1], x))
        alpha = dense(self.fc_alpha, x).float()
        feat = dense(self.fc_rgbFeat, x)
        rgb = dense(self.fc_rgb, feat).float()
        return torch.cat([rgb, feat.float(), alpha], -1)
