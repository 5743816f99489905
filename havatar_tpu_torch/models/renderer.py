"""The avatar renderer on the fused deterministic march.

Port of ``havatar_tpu/models/renderer.py``'s ``AvatarRenderer`` on its
inference path (``_render_rays_fused``, ``render_rays`` with perturb and
noise off): stratified-linspace coarse samples, skinning, plane gathers,
the coarse march kernel, deterministic inverse-CDF fine samples merged with
every 2nd coarse depth by comparison-count ranks, and the fine march kernel
compositing keeps ++ new samples in concat order.

State_dict names follow the reference ``Trainer``: ``model_coarse.*`` (the
field) and ``headpose_skin_net.canonical_Wvolume.*`` (the volume decoder).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from havatar_tpu_torch.models.nerf_field import DoublePlaneNeRFField
from havatar_tpu_torch.models.skinning import SkinningField
from havatar_tpu_torch.ops.boxwarp import get_box_warp_param
from havatar_tpu_torch.ops.march import march_coarse, march_fine
from havatar_tpu_torch.ops.volume_render import sample_pdf


class AvatarRenderer(nn.Module):
    """Field + skinning + two-pass volume rendering.

    ``compute_dtype`` is the dtype of the plane generators, of the skinning
    volume's samples and of the MLP inputs of the march (bfloat16 for the
    GPU frame: the CUDA kernels take bf16 corner rows). Geometry,
    compositing and sampling stay float32.
    """

    def __init__(self, xyz_bounding=((-1.5, 1.5), (-1.6, 1.4), (-1.6, 1.2)),
                 latent_code_dim: int = 32, cond_pose: bool = True,
                 num_encoding_fn_xyz: int = 8, plane_feat_dim: int = 64,
                 plane_res: int = 128, cond_res: int = 256,
                 plane_middle_size: int = 16, feat_dim: int = 64,
                 render_size: int = 128, skin_vol_res: int = 64,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.xyz_bounding = tuple(tuple(float(v) for v in b)
                                  for b in xyz_bounding)
        self.plane_res = plane_res
        self.render_size = render_size
        self.compute_dtype = compute_dtype
        self.model_coarse = DoublePlaneNeRFField(
            xyz_bounding=self.xyz_bounding,
            num_encoding_fn_xyz=num_encoding_fn_xyz,
            latent_code_dim=latent_code_dim + (12 if cond_pose else 0),
            plane_feat_dim=plane_feat_dim, plane_res=plane_res,
            cond_res=cond_res, plane_middle_size=plane_middle_size,
            feat_dim=feat_dim, compute_dtype=compute_dtype)
        # skinning box: the field box with Y_lo = 0.3 * Y_hi
        xb, yb, zb = [list(b) for b in self.xyz_bounding]
        yb[0] = 0.3 * yb[1]
        scales, trans = get_box_warp_param(xb, yb, zb)
        self.headpose_skin_net = SkinningField(scales, trans,
                                               vol_res=skin_vol_res)

    @property
    def gate_aabb(self):
        """``xyz_bounding`` widened by one plane texel per side: bilinear
        sampling of the zero-padded planes ramps the edge texel to zero one
        texel beyond the box, so density can reach that far."""
        return tuple((lo - (hi - lo) / (self.plane_res - 1),
                      hi + (hi - lo) / (self.plane_res - 1))
                     for lo, hi in self.xyz_bounding)

    def skin_volume(self) -> torch.Tensor:
        """The decoded canonical weight volume [1, 2, D, H, W]."""
        return self.headpose_skin_net.volume()

    def _march_inputs(self, pts: torch.Tensor, inv_head_T: torch.Tensor,
                      planes: torch.Tensor, skin_vol: torch.Tensor):
        """[B, R, S, 3] world points -> (quads [B*R, S, 8C], aux
        [B*R, S, posenc+8]) for the march kernels."""
        b, r, s = pts.shape[:3]
        can = self.headpose_skin_net(pts.reshape(b, r * s, 3), inv_head_T,
                                     skin_vol, dtype=self.compute_dtype)
        quads, aux = self.model_coarse.field_inputs_quad(can, planes)
        return (quads.reshape(b * r, s, quads.shape[-1]),
                aux.reshape(b * r, s, aux.shape[-1]))

    def render_rays(self, planes: torch.Tensor, ray_batch: torch.Tensor,
                    background_prior: torch.Tensor, inv_head_T: torch.Tensor,
                    *, num_coarse: int = 64, num_fine: int = 16,
                    fixed_volume: Optional[torch.Tensor] = None
                    ) -> Dict[str, Optional[torch.Tensor]]:
        """planes [2, B, R', R', C]; ray_batch [B, R, 8] (o, d, near, far);
        background_prior [B, R, 3]; inv_head_T [B, 4, 3]. The quads take the
        planes' dtype. Returns the JAX renderer's output dict."""
        skin_vol = self.skin_volume() if fixed_volume is None else fixed_volume
        B, R = ray_batch.shape[:2]
        ro, rd = ray_batch[..., 0:3], ray_batch[..., 3:6]
        near, far = ray_batch[..., 6:7], ray_batch[..., 7:8]
        t_vals = torch.linspace(0.0, 1.0, num_coarse, dtype=ro.dtype,
                                device=ro.device)
        z_vals = near * (1.0 - t_vals) + far * t_vals          # [B, R, S]
        pts = ro[..., None, :] + rd[..., None, :] * z_vals[..., :, None]
        quads, aux = self._march_inputs(pts, inv_head_T, planes, skin_vol)

        zf = z_vals.reshape(B * R, num_coarse)
        rd_norm = torch.linalg.norm(rd.reshape(B * R, 3), dim=-1,
                                    keepdim=True)
        d = torch.diff(zf, dim=-1)
        d = torch.cat([d, d[..., -1:]], -1) * rd_norm

        mp = self.model_coarse.march_params(quads.dtype)
        rgbmap, weights, keeps = march_coarse(quads, aux, d.float(), mp)
        bgf = background_prior.reshape(B * R, 3)

        def finish(rgbmap, w, z):
            acc = w.sum(-1, keepdim=True)
            rgb = torch.cat([rgbmap[:, :3] + (1.0 - acc) * bgf,
                             rgbmap[:, 3:]], -1)
            depth = (w * z).sum(-1, keepdim=True)
            return (rgb.reshape(B, R, -1), depth.reshape(B, R, 1),
                    acc.reshape(B, R, 1),
                    w.amax(-1, keepdim=True).reshape(B, R, 1))

        out: Dict[str, Optional[torch.Tensor]] = {}
        (out["rgb_coarse"], out["depth_coarse"], out["acc_coarse"],
         out["weights_max"]) = finish(rgbmap, weights, zf)
        out["rgb_fine"] = out["depth_fine"] = out["acc_fine"] = None
        if num_fine == 0:
            return out

        # fine pass: deterministic inverse-CDF samples, merged with every
        # 2nd coarse depth by comparison-count ranks (both lists ascend; the
        # < / <= tie rule is a stable sort of the concat)
        z_mid = 0.5 * (zf[..., 1:] + zf[..., :-1])
        z_samples = sample_pdf(z_mid, weights[..., 1:-1], num_fine)
        a, b = zf[:, ::2], z_samples
        pos_a = (torch.arange(a.shape[-1], device=a.device)
                 + (b[:, None, :] < a[:, :, None]).sum(-1))
        pos_b = (torch.arange(b.shape[-1], device=b.device)
                 + (a[:, :, None] <= b[:, None, :]).sum(1))
        ranks = torch.cat([pos_a, pos_b], -1)                  # [B*R, Sa]
        z_cat = torch.cat([a, b], -1)
        z_all = torch.empty_like(z_cat).scatter_(1, ranks, z_cat)
        d_sorted = torch.diff(z_all, dim=-1)
        d_sorted = torch.cat([d_sorted, d_sorted[..., -1:]], -1) * rd_norm
        d_concat = torch.gather(d_sorted, 1, ranks)

        z_new = z_samples.reshape(B, R, num_fine)
        pts_new = ro[..., None, :] + rd[..., None, :] * z_new[..., :, None]
        q_new, aux_new = self._march_inputs(pts_new, inv_head_T, planes,
                                            skin_vol)
        rgbmap_f, w_concat = march_fine(
            q_new, aux_new, keeps, d_concat.float(),
            ranks.to(torch.int32), mp, num_keep=num_coarse // 2)
        (out["rgb_fine"], out["depth_fine"], out["acc_fine"],
         out["weights_max"]) = finish(rgbmap_f, w_concat, z_cat)
        return out

    def forward(self, ray_batch: torch.Tensor, background_prior: torch.Tensor,
                latent_code: torch.Tensor, inv_head_T: torch.Tensor,
                front_cond: torch.Tensor, left_cond: torch.Tensor,
                right_cond: torch.Tensor, *, num_coarse: int = 64,
                num_fine: int = 16,
                fixed_volume: Optional[torch.Tensor] = None):
        B = ray_batch.shape[0]
        planes = self.model_coarse.generate_planes(
            latent_code, inv_head_T.reshape(B, -1), front_cond, left_cond,
            right_cond)
        return self.render_rays(planes, ray_batch, background_prior,
                                inv_head_T, num_coarse=num_coarse,
                                num_fine=num_fine, fixed_volume=fixed_volume)

    def render_full_image(self, *args, **kwargs
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(render [B, s, s, C], mask [B, s, s, 1]) over a full
        render_size^2 ray grid."""
        out = self(*args, **kwargs)
        rgb = out["rgb_fine"] if out["rgb_fine"] is not None else out["rgb_coarse"]
        acc = out["acc_fine"] if out["acc_fine"] is not None else out["acc_coarse"]
        B, s = rgb.shape[0], self.render_size
        return rgb.reshape(B, s, s, -1), acc.reshape(B, s, s, 1)
