"""The avatar renderer: conditioned double-plane field + skinning + two-pass
(coarse/fine) volume rendering, for inference and for training.

Port of ``havatar_tpu/models/renderer.py``'s ``AvatarRenderer``. Its three
inference configurations sit behind two constructor switches:

=================  ================  ======================================
``use_fused_march``  ``use_quad_march``  ``render_rays`` runs
=================  ================  ======================================
False (default)    (ignored)         the exact path: the field's plain dense
                                     chain and ``volume_render_radiance_field``
                                     in the compute dtype (float32 for the
                                     parity tests). JAX: the XLA path.
True               True (default)    the fused march on raw corner rows:
                                     ``march_coarse`` / ``march_fine``. JAX:
                                     ``use_pallas_march``, ``use_pallas_quad``.
True               False             the fused march on the reduced MLP
                                     input: ``march_coarse_x`` /
                                     ``march_fine_x``. JAX: ``use_pallas_march``
                                     with ``use_pallas_quad=False``.
=================  ================  ======================================

All three: stratified-linspace coarse samples, skinning, plane sampling, a
coarse pass, deterministic inverse-CDF fine samples merged with every 2nd
coarse depth by comparison-count ranks, and a fine pass that reuses the
coarse radiance at the kept depths.

Training renders stochastically: ``perturb`` jitters the coarse depths
inside their bins and draws the fine samples from stratified u, and
``radiance_field_noise_std`` adds gaussian noise to sigma before its relu in
both passes. Those renders always take the exact path (the fused march is
inference only), whose dense chain is the fused op of ``ops/mlp.py`` when the
renderer is built with ``use_fused_mlp`` (JAX: ``use_pallas_mlp``). The four
random tensors of such a render come from one place, ``draw_render_noise``,
given a ``torch.Generator``; ``render_rays`` also takes its result, a
``RenderNoise``, in the generator's place, which is how a test feeds the
port another package's draws.

State_dict names follow the reference ``Trainer``: ``model_coarse.*`` (the
field) and ``headpose_skin_net.canonical_Wvolume.*`` (the volume decoder).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple, Union

import torch
import torch.nn as nn

from havatar_tpu_torch.models.nerf_field import DoublePlaneNeRFField
from havatar_tpu_torch.models.skinning import SkinningField
from havatar_tpu_torch.ops.boxwarp import get_box_warp_param
from havatar_tpu_torch.ops.march import (
    march_coarse,
    march_coarse_x,
    march_fine,
    march_fine_x,
)
from havatar_tpu_torch.ops.volume_render import (
    sample_pdf,
    volume_render_radiance_field,
)


class RenderNoise(NamedTuple):
    """The four independent draws of one stochastic ``render_rays`` call
    over [B, R] rays; an entry the call does not need is None."""
    coarse_jitter: Optional[torch.Tensor]   # [B, R, S] uniform in [0, 1)
    coarse_sigma: Optional[torch.Tensor]    # [B*R, S] standard normal
    fine_u: Optional[torch.Tensor]          # [B*R, num_fine] uniform
    fine_sigma: Optional[torch.Tensor]      # [B*R, S/2 + num_fine] normal


def draw_render_noise(rng: torch.Generator, B: int, R: int, num_coarse: int,
                      num_fine: int, perturb: bool, noise_std: float,
                      device, dtype: torch.dtype = torch.float32
                      ) -> RenderNoise:
    """The draws ``render_rays`` needs, from ``rng`` (a generator on
    ``device``), in the order coarse jitter, coarse sigma noise, fine u, fine
    sigma noise."""
    kw = dict(generator=rng, device=device, dtype=dtype)
    fine = num_fine > 0
    noisy = noise_std > 0.0
    return RenderNoise(
        torch.rand(B, R, num_coarse, **kw) if perturb else None,
        torch.randn(B * R, num_coarse, **kw) if noisy else None,
        torch.rand(B * R, num_fine, **kw) if perturb and fine else None,
        torch.randn(B * R, (num_coarse + 1) // 2 + num_fine, **kw)
        if noisy and fine else None)


def _merge_ranks(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sorted positions of concat(a, b) for two ascending lists [R, Na],
    [R, Nb], by comparison counts; the < / <= tie rule is a stable sort of
    the concat. Returns [R, Na + Nb] int64."""
    pos_a = (torch.arange(a.shape[-1], device=a.device)
             + (b[:, None, :] < a[:, :, None]).sum(-1))
    pos_b = (torch.arange(b.shape[-1], device=b.device)
             + (a[:, :, None] <= b[:, None, :]).sum(1))
    return torch.cat([pos_a, pos_b], -1)


class AvatarRenderer(nn.Module):
    """Field + skinning + two-pass volume rendering.

    ``compute_dtype`` is the dtype of the plane generators, of the field's
    dense chain or the march kernels' MLP inputs, and (unless
    ``skin_compute_dtype`` overrides it) of the skinning volume's samples:
    bfloat16 for the GPU frame (the CUDA kernels take bf16). Geometry,
    compositing and sampling stay float32.
    """

    def __init__(self, xyz_bounding=((-1.5, 1.5), (-1.6, 1.4), (-1.6, 1.2)),
                 latent_code_dim: int = 32, cond_pose: bool = True,
                 num_encoding_fn_xyz: int = 8, plane_feat_dim: int = 64,
                 plane_res: int = 128, cond_res: int = 256,
                 plane_middle_size: int = 16, enc_mode: str = "split",
                 feat_dim: int = 64, render_size: int = 128,
                 skin_vol_res: int = 64,
                 compute_dtype: torch.dtype = torch.float32,
                 skin_compute_dtype: Optional[torch.dtype] = None,
                 use_fused_march: bool = False,
                 use_quad_march: bool = True,
                 use_fused_mlp: bool = False):
        super().__init__()
        self.xyz_bounding = tuple(tuple(float(v) for v in b)
                                  for b in xyz_bounding)
        self.plane_res = plane_res
        self.render_size = render_size
        self.compute_dtype = compute_dtype
        self.skin_compute_dtype = skin_compute_dtype or compute_dtype
        self.use_fused_march = use_fused_march
        self.use_quad_march = use_quad_march
        self.model_coarse = DoublePlaneNeRFField(
            xyz_bounding=self.xyz_bounding,
            num_encoding_fn_xyz=num_encoding_fn_xyz,
            latent_code_dim=latent_code_dim + (12 if cond_pose else 0),
            plane_feat_dim=plane_feat_dim, plane_res=plane_res,
            cond_res=cond_res, plane_middle_size=plane_middle_size,
            enc_mode=enc_mode, feat_dim=feat_dim,
            compute_dtype=compute_dtype, use_fused_mlp=use_fused_mlp)
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

    def _canonical(self, pts: torch.Tensor, inv_head_T: torch.Tensor,
                   skin_vol: torch.Tensor) -> torch.Tensor:
        """[B, R, S, 3] world points -> canonical points [B, R*S, 3]."""
        b, r, s = pts.shape[:3]
        return self.headpose_skin_net(pts.reshape(b, r * s, 3), inv_head_T,
                                      skin_vol, dtype=self.skin_compute_dtype)

    def _field_eval(self, pts: torch.Tensor, inv_head_T: torch.Tensor,
                    planes: torch.Tensor,
                    skin_vol: torch.Tensor) -> torch.Tensor:
        """[B, R, S, 3] world points -> radiance [B*R, S, C+1] through the
        field's plain dense chain."""
        b, r, s = pts.shape[:3]
        can = self._canonical(pts, inv_head_T, skin_vol)
        return self.model_coarse(can, None, planes).reshape(b * r, s, -1)

    def _march_inputs(self, pts: torch.Tensor, inv_head_T: torch.Tensor,
                      planes: torch.Tensor, skin_vol: torch.Tensor):
        """[B, R, S, 3] world points -> the march kernels' input stage as a
        tuple: (quads [B*R, S, 8C], aux [B*R, S, posenc+8]) for the quad
        kernels, (x [B*R, S, 2C+posenc],) for the reduced-input kernels."""
        b, r, s = pts.shape[:3]
        can = self._canonical(pts, inv_head_T, skin_vol)
        if self.use_quad_march:
            xs = self.model_coarse.field_inputs_quad(can, planes)
        else:
            xs = (self.model_coarse.field_inputs(can, planes),)
        return tuple(x.reshape(b * r, s, x.shape[-1]) for x in xs)

    def render_rays(self, planes: torch.Tensor, ray_batch: torch.Tensor,
                    background_prior: torch.Tensor, inv_head_T: torch.Tensor,
                    *, num_coarse: int = 64, num_fine: int = 16,
                    perturb: bool = False,
                    radiance_field_noise_std: float = 0.0,
                    rng: Union[None, torch.Generator, RenderNoise] = None,
                    fixed_volume: Optional[torch.Tensor] = None
                    ) -> Dict[str, Optional[torch.Tensor]]:
        """planes [2, B, R', R', C]; ray_batch [B, R, 8] (o, d, near, far);
        background_prior [B, R, 3]; inv_head_T [B, 4, 3]. Returns the JAX
        renderer's output dict. ``perturb`` and a positive
        ``radiance_field_noise_std`` need ``rng``: a ``torch.Generator`` on
        the rays' device, or the draws themselves as a ``RenderNoise``; such
        a render takes the exact path whatever ``use_fused_march`` says."""
        stochastic = perturb or radiance_field_noise_std > 0.0
        if rng is not None and not isinstance(rng, (torch.Generator,
                                                    RenderNoise)):
            raise TypeError(f"rng must be a torch.Generator or a RenderNoise, "
                            f"got {type(rng).__name__}")
        if stochastic and rng is None:
            raise ValueError("perturb and radiance_field_noise_std > 0 draw "
                             "random numbers: pass rng (a torch.Generator or "
                             "a RenderNoise)")
        skin_vol = self.skin_volume() if fixed_volume is None else fixed_volume
        args = (planes, ray_batch, background_prior, inv_head_T, num_coarse,
                num_fine, skin_vol)
        if self.use_fused_march and rng is None:
            return self._render_rays_fused(*args)
        noise = rng
        if isinstance(rng, torch.Generator):
            B, R = ray_batch.shape[:2]
            noise = draw_render_noise(
                rng, B, R, num_coarse, num_fine, perturb,
                radiance_field_noise_std, ray_batch.device, ray_batch.dtype)
        return self._render_rays_exact(*args, perturb,
                                       radiance_field_noise_std, noise)

    @staticmethod
    def _coarse_depths(ray_batch: torch.Tensor, num_coarse: int,
                       jitter: Optional[torch.Tensor] = None,
                       perturb: bool = False):
        """Evenly spaced depths in [near, far]; with ``perturb`` each moves
        to ``jitter`` (uniform in [0, 1), [B, R, S]) of the way through its
        bin between the neighbouring midpoints."""
        ro, rd = ray_batch[..., 0:3], ray_batch[..., 3:6]
        near, far = ray_batch[..., 6:7], ray_batch[..., 7:8]
        t_vals = torch.linspace(0.0, 1.0, num_coarse, dtype=ro.dtype,
                                device=ro.device)
        z_vals = near * (1.0 - t_vals) + far * t_vals          # [B, R, S]
        if perturb:
            if jitter is None:
                raise ValueError("perturb needs the coarse jitter draws")
            mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
            upper = torch.cat([mids, z_vals[..., -1:]], -1)
            lower = torch.cat([z_vals[..., :1], mids], -1)
            z_vals = lower + (upper - lower) * jitter.to(z_vals.dtype)
        pts = ro[..., None, :] + rd[..., None, :] * z_vals[..., :, None]
        return ro, rd, z_vals, pts

    def _render_rays_exact(self, planes, ray_batch, background_prior,
                           inv_head_T, num_coarse, num_fine, skin_vol,
                           perturb=False, noise_std=0.0,
                           noise: Optional[RenderNoise] = None):
        """The field's dense chain on every sample, then
        ``volume_render_radiance_field``; the fine pass evaluates only the
        new samples and reuses the coarse radiance at the kept depths (the
        field is a function of the point alone; sigma noise is added in the
        compositing, not in the field)."""
        B, R = ray_batch.shape[:2]
        noise = noise or RenderNoise(None, None, None, None)
        ro, rd, z_vals, pts = self._coarse_depths(
            ray_batch, num_coarse, noise.coarse_jitter if perturb else None,
            perturb)
        radiance = self._field_eval(pts, inv_head_T, planes, skin_vol)
        zf = z_vals.reshape(B * R, num_coarse)
        rdf = rd.reshape(B * R, 3)
        bgf = background_prior.reshape(B * R, 3)
        rgb_c, _, acc_c, weights, depth_c = volume_render_radiance_field(
            radiance, zf, rdf, background_prior=bgf,
            radiance_field_noise_std=noise_std, noise=noise.coarse_sigma)
        out: Dict[str, Optional[torch.Tensor]] = {
            "rgb_coarse": rgb_c.reshape(B, R, -1),
            "depth_coarse": depth_c.reshape(B, R, 1),
            "acc_coarse": acc_c.reshape(B, R, 1),
            "weights_max": weights.amax(-1).reshape(B, R, 1),
            "rgb_fine": None, "depth_fine": None, "acc_fine": None,
        }
        if num_fine == 0:
            return out

        z_mid = 0.5 * (zf[..., 1:] + zf[..., :-1])
        z_samples = sample_pdf(z_mid, weights[..., 1:-1], num_fine,
                               det=not perturb, u01=noise.fine_u).detach()
        z_keep, rad_keep = zf[:, ::2], radiance[:, ::2]
        if perturb:
            # jittered keeps and stratified samples are each ascending too,
            # but a stable sort of the concat is what the JAX package takes
            # here, and ties then break the same way
            perm = torch.argsort(torch.cat([z_keep, z_samples], -1), dim=-1,
                                 stable=True)
            ranks = torch.argsort(perm, dim=-1, stable=True)
        else:
            ranks = _merge_ranks(z_keep, z_samples)
        z_new = z_samples.reshape(B, R, num_fine)
        pts_new = ro[..., None, :] + rd[..., None, :] * z_new[..., :, None]
        rad_new = self._field_eval(pts_new, inv_head_T, planes, skin_vol)
        # reorder depths and radiance by rank (a scatter; the JAX package
        # contracts with rank one-hots, which selects the same values)
        z_cat = torch.cat([z_keep, z_samples], -1)
        rad_cat = torch.cat([rad_keep, rad_new], 1)
        z_all = torch.empty_like(z_cat).scatter_(1, ranks, z_cat)
        radiance_f = torch.empty_like(rad_cat).scatter_(
            1, ranks[..., None].expand_as(rad_cat), rad_cat)
        rgb_f, _, acc_f, weights_f, depth_f = volume_render_radiance_field(
            radiance_f, z_all, rdf, background_prior=bgf,
            radiance_field_noise_std=noise_std, noise=noise.fine_sigma)
        out["rgb_fine"] = rgb_f.reshape(B, R, -1)
        out["depth_fine"] = depth_f.reshape(B, R, 1)
        out["acc_fine"] = acc_f.reshape(B, R, 1)
        out["weights_max"] = weights_f.amax(-1).reshape(B, R, 1)
        return out

    def _render_rays_fused(self, planes, ray_batch, background_prior,
                           inv_head_T, num_coarse, num_fine, skin_vol):
        """Skinning + plane sampling + posenc build the kernels' input; the
        field MLP and the compositing run in the march kernels, the fine one
        compositing keeps ++ new samples in concat order."""
        B, R = ray_batch.shape[:2]
        quad = self.use_quad_march
        coarse, fine = ((march_coarse, march_fine) if quad
                        else (march_coarse_x, march_fine_x))
        ro, rd, z_vals, pts = self._coarse_depths(ray_batch, num_coarse)
        xs = self._march_inputs(pts, inv_head_T, planes, skin_vol)

        zf = z_vals.reshape(B * R, num_coarse)
        rd_norm = torch.linalg.norm(rd.reshape(B * R, 3), dim=-1,
                                    keepdim=True)
        d = torch.diff(zf, dim=-1)
        d = torch.cat([d, d[..., -1:]], -1) * rd_norm

        mp = self.model_coarse.march_params(xs[0].dtype, permute=quad)
        rgbmap, weights, keeps = coarse(*xs, d.float(), mp)
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

        # only depths and dists are reordered here: the kernel composites
        # in concat order by rank
        z_mid = 0.5 * (zf[..., 1:] + zf[..., :-1])
        z_samples = sample_pdf(z_mid, weights[..., 1:-1], num_fine)
        ranks = _merge_ranks(zf[:, ::2], z_samples)            # [B*R, Sa]
        z_cat = torch.cat([zf[:, ::2], z_samples], -1)
        z_all = torch.empty_like(z_cat).scatter_(1, ranks, z_cat)
        d_sorted = torch.diff(z_all, dim=-1)
        d_sorted = torch.cat([d_sorted, d_sorted[..., -1:]], -1) * rd_norm
        d_concat = torch.gather(d_sorted, 1, ranks)

        z_new = z_samples.reshape(B, R, num_fine)
        pts_new = ro[..., None, :] + rd[..., None, :] * z_new[..., :, None]
        xs_new = self._march_inputs(pts_new, inv_head_T, planes, skin_vol)
        rgbmap_f, w_concat = fine(
            *xs_new, keeps, d_concat.float(), ranks.to(torch.int32), mp,
            num_keep=num_coarse // 2)
        (out["rgb_fine"], out["depth_fine"], out["acc_fine"],
         out["weights_max"]) = finish(rgbmap_f, w_concat, z_cat)
        return out

    def forward(self, ray_batch: torch.Tensor, background_prior: torch.Tensor,
                latent_code: torch.Tensor, inv_head_T: torch.Tensor,
                front_cond: torch.Tensor, left_cond: torch.Tensor,
                right_cond: torch.Tensor, *, num_coarse: int = 64,
                num_fine: int = 16, perturb: bool = False,
                radiance_field_noise_std: float = 0.0, rng=None,
                fixed_volume: Optional[torch.Tensor] = None):
        B = ray_batch.shape[0]
        planes = self.model_coarse.generate_planes(
            latent_code, inv_head_T.reshape(B, -1), front_cond, left_cond,
            right_cond)
        return self.render_rays(
            planes, ray_batch, background_prior, inv_head_T,
            num_coarse=num_coarse, num_fine=num_fine, perturb=perturb,
            radiance_field_noise_std=radiance_field_noise_std, rng=rng,
            fixed_volume=fixed_volume)

    def render_chunked(self, ray_batch: torch.Tensor,
                       background_prior: torch.Tensor,
                       latent_code: torch.Tensor, inv_head_T: torch.Tensor,
                       front_cond: torch.Tensor, left_cond: torch.Tensor,
                       right_cond: torch.Tensor, *, chunk_size: int = 16384,
                       num_coarse: int = 64, num_fine: int = 16,
                       perturb: bool = False,
                       radiance_field_noise_std: float = 0.0, rng=None,
                       fixed_volume: Optional[torch.Tensor] = None):
        """Memory-bounded rendering: planes and the skinning volume are made
        once, then the ray axis goes through ``render_rays`` ``chunk_size``
        rays at a time. Requires R % chunk_size == 0. ``rng`` is None or a
        generator, which every chunk draws from in turn."""
        B, R = ray_batch.shape[:2]
        if isinstance(rng, RenderNoise):
            raise TypeError("render_chunked draws per chunk: pass a "
                            "torch.Generator, not a RenderNoise")
        if R % chunk_size:
            raise ValueError(f"R={R} is not a multiple of chunk_size="
                             f"{chunk_size}; pad the rays")
        planes = self.model_coarse.generate_planes(
            latent_code, inv_head_T.reshape(B, -1), front_cond, left_cond,
            right_cond)
        skin_vol = self.skin_volume() if fixed_volume is None else fixed_volume
        outs = [self.render_rays(
            planes, ray_batch[:, i:i + chunk_size],
            background_prior[:, i:i + chunk_size], inv_head_T,
            num_coarse=num_coarse, num_fine=num_fine, perturb=perturb,
            radiance_field_noise_std=radiance_field_noise_std, rng=rng,
            fixed_volume=skin_vol) for i in range(0, R, chunk_size)]
        return {k: None if v is None else torch.cat([o[k] for o in outs], 1)
                for k, v in outs[0].items()}

    def render_full_image(self, *args, **kwargs
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(render [B, s, s, C], mask [B, s, s, 1]) over a full
        render_size^2 ray grid."""
        out = self(*args, **kwargs)
        rgb = out["rgb_fine"] if out["rgb_fine"] is not None else out["rgb_coarse"]
        acc = out["acc_fine"] if out["acc_fine"] is not None else out["acc_coarse"]
        B, s = rgb.shape[0], self.render_size
        return rgb.reshape(B, s, s, -1), acc.reshape(B, s, s, 1)


def latent_code_loss(latent_codes: torch.Tensor,
                     latent_code: torch.Tensor) -> torch.Tensor:
    """Pull the selected codes [B, D] towards the mean of all codes
    [N, D], the mean taken as a constant."""
    mean = latent_codes.mean(dim=0, keepdim=True).detach()
    return (latent_code - mean).square().mean()
