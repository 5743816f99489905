"""Facial-model-conditioned double-plane NeRF field.

Port of ``havatar_tpu/models/nerf_field.py``: ``generate_planes`` in its
three ``enc_mode``s ('split': two PlaneGenerators, XY from the front
condition, ZY from the horizontally flipped left condition without its mask
channel ++ the right condition; 'shared_backbone': one double-width
PlaneGenerator over all three, planes split on channels; 'two_head': a
TwoHeadPlaneGenerator), the three ways a renderer feeds the five dense
layers:

* ``forward``: plane features ++ posenc through the dense chain, the exact
  renderer's field evaluation: five ``F.linear`` calls, or
  with ``use_fused_mlp`` the fused op ``ops/mlp.py:fused_mlp_chain``, whose
  forward and backward are one CUDA kernel each (JAX: ``use_pallas_mlp``),
  or with ``use_fused_quad`` (which takes precedence) the op
  ``ops/mlp_quad.py:field_radiance_quad`` on each batch item, whose kernels
  also take in the gather of the corner texels, the corner reduction and
  the splat of the plane gradients (JAX: ``use_pallas_mlp_quad``). The
  fused ops compute the ``sh_deg = 0`` head only, so with ``sh_deg > 0``
  (``fc_rgb`` 3 (sh_deg + 1)^2 wide, rgb the SH at the view directions,
  ``ops/sh.py:eval_sh``) ``forward`` takes the five ``F.linear`` calls
  whatever the flags say, as JAX does; the renderer builds its field with
  ``sh_deg = 0``, as JAX's does;
* ``field_inputs``: that chain's input alone, [B, N, 2C + posenc] in the
  compute dtype and the reference's interleaved channel order, for the
  reduced-input march kernels (``march_params(dtype, permute=False)``);
* ``field_inputs_cells``: each point's bilinear cell in both planes +
  posenc + corner weights, for the quad march kernels, which gather the
  corner texels from the planes themselves (``march_params(dtype)``);
  ``field_inputs_quad`` gathers those corner rows in PyTorch instead (JAX's
  quad kernels take them).

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
from havatar_tpu_torch.ops.mlp_quad import field_radiance_quad, quad_rows
from havatar_tpu_torch.ops.sh import eval_sh


class DoublePlaneNeRFField(nn.Module):
    def __init__(self, xyz_bounding=((-1.5, 1.5), (-1.6, 1.4), (-1.6, 1.2)),
                 num_encoding_fn_xyz: int = 8, latent_code_dim: int = 44,
                 plane_feat_dim: int = 64, plane_res: int = 128,
                 cond_res: int = 256, plane_middle_size: int = 16,
                 enc_mode: str = "split", hidden: int = 128,
                 feat_dim: int = 64, sh_deg: int = 0,
                 compute_dtype: torch.dtype = torch.float32,
                 use_fused_mlp: bool = False, use_fused_quad: bool = False,
                 sorted_scatter: bool = False):
        super().__init__()
        self.use_fused_mlp = use_fused_mlp
        self.use_fused_quad = use_fused_quad
        # the quad op's plain splat (the CUDA kernel has no order to choose)
        self.sorted_scatter = sorted_scatter
        self.num_encoding_fn_xyz = num_encoding_fn_xyz
        self.plane_feat_dim = plane_feat_dim
        self.enc_mode = enc_mode
        self.sh_deg = sh_deg
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
        self.fc_rgb = nn.Linear(feat_dim, 3 * (sh_deg + 1) ** 2)

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

    def field_inputs_cells(self, pts: torch.Tensor, planes: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
        """[B, N, 3] canonical points, planes [2, B, R, R, C] -> (rows
        [B, N, 2] int32: each point's bilinear cell y0 * (W - 1) + x0 in the
        XY plane, then in the ZY plane; aux [B, N, posenc + 8] f32, as
        ``field_inputs_quad``'s). The cells address the same four corner
        texels as ``field_inputs_quad``'s corner rows, with the same
        weights (zeros padding)."""
        B, N, _ = pts.shape
        H, W = planes.shape[2:4]
        rows, w8 = quad_rows(self.gridwarper(pts).reshape(-1, 3), H, W)
        pe = positional_encoding(pts, self.num_encoding_fn_xyz)
        return (rows.reshape(B, N, 2),
                torch.cat([pe.float(), w8.reshape(B, N, 8)], -1))

    def march_params(self, dtype: torch.dtype,
                     permute: bool = True) -> MarchParams:
        """The five dense layers as the march kernels take them: layer0 in
        block order for the quad kernels, ``permute=False`` for the kernels
        that take ``field_inputs``."""
        return march_params(self.layers_xyz, self.fc_rgbFeat, self.fc_alpha,
                            self.fc_rgb, self.plane_feat_dim,
                            posenc_dim(self.num_encoding_fn_xyz), dtype,
                            permute=permute)

    def dense_params(self) -> Tuple[torch.Tensor, ...]:
        """The five dense layers' tensors in the fused ops' order (w0, b0,
        w1, b1, w_feat, b_feat, w_alpha, b_alpha, w_rgb, b_rgb), as they are
        (not detached): an op's backward fills their ``.grad``."""
        l0, l1 = self.layers_xyz
        return (l0.weight, l0.bias, l1.weight, l1.bias, self.fc_rgbFeat.weight,
                self.fc_rgbFeat.bias, self.fc_alpha.weight,
                self.fc_alpha.bias, self.fc_rgb.weight, self.fc_rgb.bias)

    def forward(self, pts: torch.Tensor, viewdirs: Optional[torch.Tensor],
                planes: torch.Tensor) -> torch.Tensor:
        """[B, N, 3] canonical points -> radiance [B, N, 3 + feat + 1] f32
        (rgb, features, sigma). ``viewdirs`` [B, N, 3] (unit) is read only
        with ``sh_deg > 0``. The dense layers run in the compute dtype."""
        cdt = self.compute_dtype

        def dense(lin, x):
            return F.linear(x, lin.weight.to(cdt), lin.bias.to(cdt))

        if self.use_fused_quad and self.sh_deg == 0:
            # one op call a batch item, on that item's planes
            warped = self.gridwarper(pts)
            pe = positional_encoding(pts, self.num_encoding_fn_xyz).float()
            return torch.stack([field_radiance_quad(
                planes[0][b], planes[1][b], warped[b], pe[b],
                *self.dense_params(), sorted_scatter=self.sorted_scatter)
                for b in range(pts.shape[0])])
        x = self.field_inputs(pts, planes)
        if self.use_fused_mlp and self.sh_deg == 0:
            B, N, fin = x.shape
            out = fused_mlp_chain(x.reshape(B * N, fin), *self.dense_params())
            return out.reshape(B, N, -1)
        x = torch.relu(dense(self.layers_xyz[0], x))
        x = torch.relu(dense(self.layers_xyz[1], x))
        alpha = dense(self.fc_alpha, x).float()
        feat = dense(self.fc_rgbFeat, x)
        rgb = dense(self.fc_rgb, feat).float()
        if self.sh_deg > 0:
            rgb = eval_sh(self.sh_deg,
                          rgb.reshape(*rgb.shape[:-1], -1,
                                      (self.sh_deg + 1) ** 2), viewdirs)
        return torch.cat([rgb, feat.float(), alpha], -1)
