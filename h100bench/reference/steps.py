"""What each cell's timed path computes, in plain PyTorch: a stage-1
training step and a stage-2 D / R1 / G iteration.

Frozen copies of the semantics of ``train/stage1.py`` (``make_loss_fn``,
``make_train_step``) and ``train/stage2.py`` (``make_steps``: ``d_step``,
``r1_step``, ``g_step``) on one device, on this folder's modules. Random
draws come from a ``torch.Generator`` in the order the program draws them,
so that one generator state gives both sides the same noise; the EMA of the
generator is left out (nothing compared reads it).

Nothing here imports the program under test.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple

import torch

from . import losses as L
from .discriminator import WaveletDiscriminator
from .generators import StyleUNetSR
from .lpips import lpips_loss
from .renderer import (
    AvatarRenderer,
    RenderNoise,
    draw_render_noise,
    latent_code_loss,
)

Batch = Dict[str, torch.Tensor]


def build_renderer(cfg: Dict[str, Any]) -> AvatarRenderer:
    """The renderer a configuration dict describes, in float32."""
    coarse = cfg["models"]["coarse"]
    return AvatarRenderer(
        xyz_bounding=tuple(tuple(b) for b in coarse["XYZ_bounding"]),
        latent_code_dim=cfg["experiment"]["latent_code_dim"],
        cond_pose=cfg["experiment"]["cond_pose"],
        num_encoding_fn_xyz=coarse.get("num_encoding_fn_xyz", 8),
        plane_feat_dim=coarse.get("plane_feat_dim", 64),
        plane_res=coarse.get("plane_res", 128),
        plane_middle_size=coarse.get("plane_middle_size", 16),
        skin_vol_res=coarse.get("skin_vol_res", 64),
        feat_dim=cfg["models"]["StyleUnet"]["inp_ch"],
        render_size=cfg["models"]["StyleUnet"]["inp_size"],
        cond_res=cfg["dataset"]["cond_render_res"])


def build_generator(cfg: Dict[str, Any]) -> StyleUNetSR:
    gan, su = cfg["gan"], cfg["models"]["StyleUnet"]
    return StyleUNetSR(
        inp_size=su["inp_size"], inp_ch=su["inp_ch"], out_ch=3,
        out_size=su["out_size"], style_dim=gan["latent"], n_mlp=gan["n_mlp"],
        channel_multiplier=gan["channel_multiplier"])


def build_discriminator(cfg: Dict[str, Any]) -> WaveletDiscriminator:
    return WaveletDiscriminator(
        size=cfg["models"]["StyleUnet"]["out_size"], img_channel=3,
        channel_multiplier=cfg["gan"]["channel_multiplier"])


# ---------------------------------------------------------------------------
# stage 1
# ---------------------------------------------------------------------------

class Stage1:
    """A stage-1 run: renderer, latent codes and one Adam over both."""

    def __init__(self, cfg: Dict[str, Any], renderer: AvatarRenderer,
                 latent_codes: torch.Tensor, lpips_params):
        self.cfg, self.renderer = cfg, renderer.train()
        self.latent_codes = torch.nn.Parameter(latent_codes)
        self.lpips_params = lpips_params
        self.params = list(renderer.parameters()) + [self.latent_codes]
        self.opt = torch.optim.Adam(self.params, lr=cfg["optimizer"]["lr"],
                                    eps=1e-8)
        self.step_count = 0

    def loss(self, batch: Batch, rng: torch.Generator):
        cfg = self.cfg
        nerf = cfg["nerf"]["train"]
        rays = batch["mv_rays"]
        B, R = rays.shape[:2]
        noise = draw_render_noise(
            rng, B, R, nerf["num_coarse"], nerf["num_fine"],
            bool(nerf["perturb"]), float(nerf["radiance_field_noise_std"]),
            rays.device)
        latent = self.latent_codes[batch["dataset_idx"]]
        out = self.renderer(
            rays[..., :8], rays[..., 8:11], latent, batch["inv_head_T"],
            batch["front_render_cond"], batch["left_render_cond"],
            batch["right_render_cond"], num_coarse=nerf["num_coarse"],
            num_fine=nerf["num_fine"], perturb=bool(nerf["perturb"]),
            noise_std=float(nerf["radiance_field_noise_std"]), noise=noise)
        target, ray_mask = batch["gt_color"], rays[..., -1:]
        mask_weight = cfg["experiment"]["mask_weight"]
        l1 = cfg["experiment"]["rgb_loss"] != "mse"

        def rgb_loss(a, b):
            return (a - b).abs().mean() if l1 else (a - b).square().mean()

        loss = (rgb_loss(out["rgb_coarse"][..., :3], target)
                + mask_weight * L.binary_cross_entropy(out["acc_coarse"],
                                                       ray_mask))
        rgb = out["rgb_coarse"][..., :3]
        if out["rgb_fine"] is not None:
            rgb = out["rgb_fine"][..., :3]
            loss = (loss + rgb_loss(rgb, target) + mask_weight
                    * L.binary_cross_entropy(out["acc_fine"], ray_mask))
        if cfg["experiment"].get("patch_rgb") and self.lpips_params:
            ps = int(R ** 0.5)
            loss = loss + 0.05 * lpips_loss(
                self.lpips_params, rgb.reshape(B, ps, ps, 3),
                target.reshape(B, ps, ps, 3))
        loss = loss + latent_code_loss(self.latent_codes, latent)
        sw = L.skin_weight_tv_loss(self.renderer.skin_volume()[0, 1])
        return loss + 1e-4 * sw

    def step(self, batch: Batch, rng: torch.Generator) -> Dict[str, float]:
        sch = self.cfg["scheduler"]
        self.opt.zero_grad(set_to_none=True)
        loss = self.loss(batch, rng)
        loss.backward()
        lr = L.stage1_lr(self.step_count, base_lr=self.cfg["optimizer"]["lr"],
                         decay_factor=sch["lr_decay_factor"],
                         decay_kilosteps=sch["lr_decay"],
                         floor=sch.get("lr_floor", 5e-5))
        for pg in self.opt.param_groups:
            pg["lr"] = lr
        self.opt.step()
        self.step_count += 1
        return {"loss": float(loss.detach())}


# ---------------------------------------------------------------------------
# stage 2
# ---------------------------------------------------------------------------

class StyleDraws(NamedTuple):
    z0: torch.Tensor
    z1: torch.Tensor
    inject_index: int
    noise: List[torch.Tensor]


class Stage2:
    """A stage-2 run: renderer and latent codes (one Adam), generator and
    discriminator (Adam with beta1 0 and the lazy-regularisation ratio)."""

    def __init__(self, cfg: Dict[str, Any], renderer: AvatarRenderer,
                 generator: StyleUNetSR, discriminator: WaveletDiscriminator,
                 latent_codes: torch.Tensor, lpips_params):
        gan = cfg["gan"]
        self.cfg, self.gan = cfg, gan
        self.renderer = renderer.train()
        self.gen, self.disc = generator.train(), discriminator.train()
        self.latent_codes = torch.nn.Parameter(latent_codes)
        self.lpips_params = lpips_params
        self.nerf_params = list(renderer.parameters()) + [self.latent_codes]
        g_ratio = gan["g_reg_every"] / (gan["g_reg_every"] + 1)
        d_ratio = gan["d_reg_every"] / (gan["d_reg_every"] + 1)
        self.nerf_opt = torch.optim.Adam(
            self.nerf_params, lr=cfg["optimizer"]["lr"], eps=1e-8)
        self.g_opt = torch.optim.Adam(
            list(generator.parameters()), lr=gan["lr"] * g_ratio,
            betas=(0.0, 0.99 ** g_ratio), eps=1e-8)
        self.d_opt = torch.optim.Adam(
            list(discriminator.parameters()), lr=gan["lr"] * d_ratio,
            betas=(0.0, 0.99 ** d_ratio), eps=1e-8)
        self.step_count = 0

    def _draws(self, batch: Batch, rng: torch.Generator):
        nerf = self.cfg["nerf"]["train"]
        rays = batch["mv_rays"]
        B, R = rays.shape[:2]
        dev = rays.device
        render = draw_render_noise(
            rng, B, R, nerf["num_coarse"], nerf["num_fine"],
            bool(nerf["perturb"]), float(nerf["radiance_field_noise_std"]),
            dev)
        kw = dict(generator=rng, device=dev)
        z = torch.randn(2, B, self.gan["latent"], **kw)
        mix = float(torch.rand((), **kw)) < self.gan["mixing"]
        idx = int(torch.randint(1, self.gen.n_latent, (), **kw))
        noise = [torch.randn(s, **kw) for s in self.gen.noise_shapes(B)]
        return render, StyleDraws(z[0], z[1], idx if mix
                                  else self.gen.n_latent, noise)

    def _render(self, batch: Batch, noise: RenderNoise):
        nerf = self.cfg["nerf"]["train"]
        rays = batch["mv_rays"]
        latent = self.latent_codes[batch["dataset_idx"]]
        render, mask = self.renderer.render_image(
            rays[..., :8], rays[..., 8:11], latent, batch["inv_head_T"],
            batch["front_render_cond"], batch["left_render_cond"],
            batch["right_render_cond"], num_coarse=nerf["num_coarse"],
            num_fine=nerf["num_fine"], perturb=bool(nerf["perturb"]),
            noise_std=float(nerf["radiance_field_noise_std"]), noise=noise)
        return render, mask, latent_code_loss(self.latent_codes, latent)

    def _generate(self, render, s: StyleDraws):
        return self.gen([s.z0, s.z1], render[..., 3:].permute(0, 3, 1, 2),
                        noise=s.noise, inject_index=s.inject_index)

    def d_step(self, batch: Batch, rng: torch.Generator) -> Dict[str, float]:
        noise, styles = self._draws(batch, rng)
        with torch.no_grad():
            render, _, _ = self._render(batch, noise)
            fake = self._generate(render, styles)
        self.d_opt.zero_grad(set_to_none=True)
        real = batch["gt_hr_img"].permute(0, 3, 1, 2)
        loss = L.d_logistic_loss(self.disc(real), self.disc(fake))
        (loss * L.gan_loss_weight(self.step_count)).backward()
        self.d_opt.step()
        return {"d": float(loss.detach())}

    def r1_step(self, batch: Batch) -> Dict[str, float]:
        gan = self.gan
        self.d_opt.zero_grad(set_to_none=True)
        r1 = L.d_r1_penalty(self.disc, batch["gt_hr_img"].permute(0, 3, 1, 2))
        ((gan["r1"] / 2.0) * r1 * L.gan_loss_weight(self.step_count)
         * gan["d_reg_every"]).backward()
        self.d_opt.step()
        return {"r1": float(r1.detach())}

    def g_step(self, batch: Batch, rng: torch.Generator) -> Dict[str, float]:
        cfg = self.cfg
        render_size = cfg["models"]["StyleUnet"]["inp_size"]
        gen_size = cfg["models"]["StyleUnet"]["out_size"]
        mask_weight = cfg["experiment"]["mask_weight"]
        noise, styles = self._draws(batch, rng)
        self.nerf_opt.zero_grad(set_to_none=True)
        self.g_opt.zero_grad(set_to_none=True)
        gt_hr = batch["gt_hr_img"]
        gt_lr_up = L.downsample_bilinear(
            L.downsample_bilinear(gt_hr, render_size), gen_size)
        render, mask, code_loss = self._render(batch, noise)
        lr_up = L.downsample_bilinear(render[..., :3], gen_size)
        nerf_loss = (lr_up - gt_lr_up).square().mean() + code_loss
        if mask_weight > 0:
            nerf_loss = nerf_loss + mask_weight * L.binary_cross_entropy(
                mask, batch["gt_lr_mask"])
        fake = self._generate(render, styles)
        flags = [p.requires_grad for p in self.disc.parameters()]
        self.disc.requires_grad_(False)
        adv = L.g_nonsaturating_loss(self.disc(fake))
        for p, f in zip(self.disc.parameters(), flags):
            p.requires_grad_(f)
        gt = gt_hr.permute(0, 3, 1, 2)
        hr_l1 = (fake - gt).abs().mean()
        total = nerf_loss + adv * L.gan_loss_weight(self.step_count) + hr_l1
        percep = torch.zeros(())
        if self.lpips_params:
            percep = lpips_loss(self.lpips_params, fake.permute(0, 2, 3, 1),
                                gt_hr)
            total = total + 0.1 * percep
        total.backward()
        self.nerf_opt.step()
        self.g_opt.step()
        self.step_count += 1
        return {k: float(v.detach()) for k, v in (
            ("nerf_loss", nerf_loss), ("g", adv), ("hr_l1", hr_l1),
            ("percep", percep))}
