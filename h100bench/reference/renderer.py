"""The avatar renderer, plain PyTorch: conditioned double-plane field,
head-pose skinning and two-pass (coarse / fine) volume rendering.

A frozen copy of the exact path of ``havatar_tpu_torch/models/renderer.py``
(the reference's ``Trainer`` render): evenly spaced (or, with ``perturb``,
jittered) coarse depths, skinning, plane sampling, the field's five dense
layers on every sample, compositing, deterministic (or stratified)
inverse-CDF fine samples merged with every 2nd coarse depth, and a fine pass
that reuses the coarse radiance at the kept depths. The fused march and the
fused training ops of the program compute this same function.

Training noise comes from a ``torch.Generator`` in the order coarse jitter,
coarse sigma noise, fine u, fine sigma noise: the order the program draws
them in, so that one generator state gives both the same draws.

State_dict names follow the reference: ``model_coarse.*`` and
``headpose_skin_net.canonical_Wvolume.*``.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch
import torch.nn as nn

from .boxwarp import get_box_warp_param
from .nerf_field import DoublePlaneNeRFField
from .skinning import SkinningField
from .volume_render import sample_pdf, volume_render_radiance_field


class RenderNoise(NamedTuple):
    coarse_jitter: Optional[torch.Tensor]   # [B, R, S] uniform in [0, 1)
    coarse_sigma: Optional[torch.Tensor]    # [B*R, S] standard normal
    fine_u: Optional[torch.Tensor]          # [B*R, num_fine] uniform
    fine_sigma: Optional[torch.Tensor]      # [B*R, S/2 + num_fine] normal


def draw_render_noise(rng: torch.Generator, B: int, R: int, num_coarse: int,
                      num_fine: int, perturb: bool, noise_std: float,
                      device) -> RenderNoise:
    kw = dict(generator=rng, device=device, dtype=torch.float32)
    fine = num_fine > 0
    noisy = noise_std > 0.0
    return RenderNoise(
        torch.rand(B, R, num_coarse, **kw) if perturb else None,
        torch.randn(B * R, num_coarse, **kw) if noisy else None,
        torch.rand(B * R, num_fine, **kw) if perturb and fine else None,
        torch.randn(B * R, (num_coarse + 1) // 2 + num_fine, **kw)
        if noisy and fine else None)


def merge_ranks(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sorted positions of concat(a, b) for two ascending lists [R, Na],
    [R, Nb] by comparison counts (a stable sort of the concat)."""
    pos_a = (torch.arange(a.shape[-1], device=a.device)
             + (b[:, None, :] < a[:, :, None]).sum(-1))
    pos_b = (torch.arange(b.shape[-1], device=b.device)
             + (a[:, :, None] <= b[:, None, :]).sum(1))
    return torch.cat([pos_a, pos_b], -1)


class AvatarRenderer(nn.Module):
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
        self.render_size = render_size
        self.model_coarse = DoublePlaneNeRFField(
            xyz_bounding=self.xyz_bounding,
            num_encoding_fn_xyz=num_encoding_fn_xyz,
            latent_code_dim=latent_code_dim + (12 if cond_pose else 0),
            plane_feat_dim=plane_feat_dim, plane_res=plane_res,
            cond_res=cond_res, plane_middle_size=plane_middle_size,
            feat_dim=feat_dim, compute_dtype=compute_dtype)
        xb, yb, zb = [list(b) for b in self.xyz_bounding]
        yb[0] = 0.3 * yb[1]
        scales, trans = get_box_warp_param(xb, yb, zb)
        self.headpose_skin_net = SkinningField(scales, trans,
                                               vol_res=skin_vol_res)

    def skin_volume(self) -> torch.Tensor:
        return self.headpose_skin_net.volume()

    def _field_eval(self, pts, inv_head_T, planes, skin_vol):
        """[B, R, S, 3] world points -> radiance [B*R, S, C+1]."""
        b, r, s = pts.shape[:3]
        can = self.headpose_skin_net(pts.reshape(b, r * s, 3), inv_head_T,
                                     skin_vol)
        return self.model_coarse(can, planes).reshape(b * r, s, -1)

    def render_rays(self, planes, ray_batch, background_prior, inv_head_T, *,
                    num_coarse: int = 64, num_fine: int = 16,
                    perturb: bool = False, noise_std: float = 0.0,
                    noise: Optional[RenderNoise] = None,
                    fixed_volume: Optional[torch.Tensor] = None
                    ) -> Dict[str, Optional[torch.Tensor]]:
        B, R = ray_batch.shape[:2]
        skin_vol = self.skin_volume() if fixed_volume is None else fixed_volume
        noise = noise or RenderNoise(None, None, None, None)
        ro, rd = ray_batch[..., 0:3], ray_batch[..., 3:6]
        near, far = ray_batch[..., 6:7], ray_batch[..., 7:8]
        t_vals = torch.linspace(0.0, 1.0, num_coarse, dtype=ro.dtype,
                                device=ro.device)
        z_vals = near * (1.0 - t_vals) + far * t_vals
        if perturb:
            mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
            upper = torch.cat([mids, z_vals[..., -1:]], -1)
            lower = torch.cat([z_vals[..., :1], mids], -1)
            z_vals = lower + (upper - lower) * noise.coarse_jitter
        pts = ro[..., None, :] + rd[..., None, :] * z_vals[..., :, None]
        radiance = self._field_eval(pts, inv_head_T, planes, skin_vol)
        zf = z_vals.reshape(B * R, num_coarse)
        rdf = rd.reshape(B * R, 3)
        bgf = background_prior.reshape(B * R, 3)
        rgb_c, _, acc_c, weights, _ = volume_render_radiance_field(
            radiance, zf, rdf, background_prior=bgf,
            radiance_field_noise_std=noise_std, noise=noise.coarse_sigma)
        out: Dict[str, Optional[torch.Tensor]] = {
            "rgb_coarse": rgb_c.reshape(B, R, -1),
            "acc_coarse": acc_c.reshape(B, R, 1),
            "rgb_fine": None, "acc_fine": None}
        if num_fine == 0:
            return out
        z_mid = 0.5 * (zf[..., 1:] + zf[..., :-1])
        z_samples = sample_pdf(z_mid, weights[..., 1:-1], num_fine,
                               det=not perturb, u01=noise.fine_u).detach()
        z_keep, rad_keep = zf[:, ::2], radiance[:, ::2]
        if perturb:
            perm = torch.argsort(torch.cat([z_keep, z_samples], -1), dim=-1,
                                 stable=True)
            ranks = torch.argsort(perm, dim=-1, stable=True)
        else:
            ranks = merge_ranks(z_keep, z_samples)
        z_new = z_samples.reshape(B, R, num_fine)
        pts_new = ro[..., None, :] + rd[..., None, :] * z_new[..., :, None]
        rad_new = self._field_eval(pts_new, inv_head_T, planes, skin_vol)
        z_cat = torch.cat([z_keep, z_samples], -1)
        rad_cat = torch.cat([rad_keep, rad_new], 1)
        z_all = torch.empty_like(z_cat).scatter_(1, ranks, z_cat)
        radiance_f = torch.empty_like(rad_cat).scatter_(
            1, ranks[..., None].expand_as(rad_cat), rad_cat)
        rgb_f, _, acc_f, _, _ = volume_render_radiance_field(
            radiance_f, z_all, rdf, background_prior=bgf,
            radiance_field_noise_std=noise_std, noise=noise.fine_sigma)
        out["rgb_fine"] = rgb_f.reshape(B, R, -1)
        out["acc_fine"] = acc_f.reshape(B, R, 1)
        return out

    def forward(self, ray_batch, background_prior, latent_code, inv_head_T,
                front_cond, left_cond, right_cond, **kw):
        B = ray_batch.shape[0]
        planes = self.model_coarse.generate_planes(
            latent_code, inv_head_T.reshape(B, -1), front_cond, left_cond,
            right_cond)
        return self.render_rays(planes, ray_batch, background_prior,
                                inv_head_T, **kw)

    def render_image(self, *args, **kw):
        """(render [B, s, s, C], opacity [B, s, s, 1]) over the full
        render_size^2 ray grid: the fine pass's, else the coarse one's."""
        out = self(*args, **kw)
        fine = out["rgb_fine"] is not None
        rgb = out["rgb_fine"] if fine else out["rgb_coarse"]
        acc = out["acc_fine"] if fine else out["acc_coarse"]
        B, s = rgb.shape[0], self.render_size
        return rgb.reshape(B, s, s, -1), acc.reshape(B, s, s, 1)


def latent_code_loss(latent_codes: torch.Tensor,
                     latent_code: torch.Tensor) -> torch.Tensor:
    mean = latent_codes.mean(dim=0, keepdim=True).detach()
    return (latent_code - mean).square().mean()
