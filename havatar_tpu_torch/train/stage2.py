"""Stage-2 HD training: the NeRF renders its full 128^2 feature image, the
StyleUNet generator lifts it to 512^2 and a wavelet discriminator judges it.

Port of ``havatar_tpu/train/stage2.py``. The steps, as in the reference's
``train_avatarHD.py``:

* ``d_step``: a no-grad render, the generator's image of it, the logistic D
  loss times the ramped GAN weight min(1e-3 * 1.1^(step // 500), 0.1), an
  update of D.
* ``r1_step`` (every ``d_reg_every`` iterations, from 0): (r1 / 2) * R1 *
  weight * d_reg_every on the real images, an update of D. R1 is a gradient
  of D's gradient, so D is differentiated twice; the field's fused ops are
  not on that path.
* ``g_step``: the render with gradients; the MSE between the render's
  colour and the target, both bilinearly resampled to 128^2 and back to
  512^2, the mask BCE and the latent-code pull; the adversarial loss
  through the pre-step D, the 512^2 L1 (and 0.1 LPIPS with weights); one
  backward through the generator into the NeRF (the feature image is not
  detached); updates of the NeRF side and of G; the EMA of G.
* ``dg_step``: one render shared by both losses (the JAX fast step): the G
  loss as in ``g_step``, and D's loss on the same fake image, detached,
  taken on the pre-step D.

Optimizers: Adam on the NeRF side (the config's rate), Adam with beta1 = 0,
beta2 = 0.99^ratio and rate lr * ratio on G and D, ratio =
reg_every / (reg_every + 1); eps 1e-8 as in optax.

Where the JAX steps take a PRNG key, these take a ``torch.Generator`` or,
from a test, the draws themselves (``Stage2Draws``: the render's
``RenderNoise`` and the generator's ``StyleDraws``). The render is not
rematerialised: the JAX package recomputes it in the backward to fit a 16 GB
chip, and PyTorch would draw its noise again there; the peak memory without
it is measured on the card instead.

On several GPUs (``mesh``, as ``train/stage1.py``'s) the batch is split on
the rays (the JAX package's ``shard_map`` route): each rank renders its
block of the rays and the [B, 128, 128, 3 + 64] feature image is
all-gathered; the generator, the discriminator, LPIPS and R1 then run on
every rank on the whole batch and the same style draws. The G and D
gradients are averaged over the ranks before each update, and the EMA moves
alike on every rank. The frames are never split here: the discriminator's
minibatch-stddev channel mixes the items of a batch, so D on a rank's
frames is not D on the batch.
"""

from __future__ import annotations

import copy
import contextlib
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple, Union

import torch

from havatar_tpu_torch.device import resolve_device
from havatar_tpu_torch.models.discriminator import WaveletDiscriminator
from havatar_tpu_torch.models.generators import StyleUNetSR
from havatar_tpu_torch.models.renderer import (
    AvatarRenderer,
    RenderNoise,
    draw_render_noise,
    latent_code_loss,
)
from havatar_tpu_torch.parallel import comm
from havatar_tpu_torch.parallel.mesh import mesh_rank_size
from havatar_tpu_torch.train import losses as L
from havatar_tpu_torch.train.ema import ema_update
from havatar_tpu_torch.train.lpips import lpips_loss
from havatar_tpu_torch.train.stage1 import _DTYPES, build_renderer, rank_rng
from havatar_tpu_torch.utils.profiling import span

EMA_DECAY = 0.5 ** (32.0 / (10 * 1000))
Metrics = Dict[str, torch.Tensor]


class StyleDraws(NamedTuple):
    """The generator's draws of one step: two style codes [B, latent], the
    layer from which the second one drives the decoder (``n_latent``: never)
    and a noise tensor for each StyledConv."""
    z0: torch.Tensor
    z1: torch.Tensor
    inject_index: int
    noise: List[torch.Tensor]


class Stage2Draws(NamedTuple):
    render: RenderNoise
    styles: StyleDraws


Rng = Union[torch.Generator, Stage2Draws]


@dataclass
class Stage2State:
    """What a stage-2 run carries; ``step`` counts generator steps."""
    renderer: AvatarRenderer
    latent_codes: torch.nn.Parameter
    generator: StyleUNetSR
    discriminator: WaveletDiscriminator
    g_ema: StyleUNetSR
    nerf_opt: torch.optim.Optimizer
    g_opt: torch.optim.Optimizer
    d_opt: torch.optim.Optimizer
    step: int = 0


def build_models(cfg, **renderer_overrides
                 ) -> Tuple[AvatarRenderer, StyleUNetSR, WaveletDiscriminator]:
    """The renderer (``build_renderer``, with ``renderer_overrides``), the
    generator and the discriminator a config describes. The GAN nets run in
    ``models.gan_compute_dtype`` (float32 by default), apart from the NeRF's
    ``compute_dtype``."""
    renderer = build_renderer(cfg, **renderer_overrides)
    gan, su = cfg.gan, cfg.models.StyleUnet
    gan_dtype = _DTYPES[cfg.models.get("gan_compute_dtype", "float32")]
    generator = StyleUNetSR(
        inp_size=su.inp_size, inp_ch=su.inp_ch, out_ch=3,
        out_size=su.out_size, style_dim=gan.latent, n_mlp=gan.n_mlp,
        channel_multiplier=gan.channel_multiplier, compute_dtype=gan_dtype)
    discriminator = WaveletDiscriminator(
        size=su.out_size, img_channel=3,
        channel_multiplier=gan.channel_multiplier, compute_dtype=gan_dtype)
    return renderer, generator, discriminator


def make_optimizers(cfg, nerf_params, g_params, d_params):
    """(nerf_opt, g_opt, d_opt) over the three parameter lists."""
    gan = cfg.gan
    g_ratio = gan.g_reg_every / (gan.g_reg_every + 1)
    d_ratio = gan.d_reg_every / (gan.d_reg_every + 1)
    return (torch.optim.Adam(nerf_params, lr=cfg.optimizer.lr, eps=1e-8),
            torch.optim.Adam(g_params, lr=gan.lr * g_ratio,
                             betas=(0.0, 0.99 ** g_ratio), eps=1e-8),
            torch.optim.Adam(d_params, lr=gan.lr * d_ratio,
                             betas=(0.0, 0.99 ** d_ratio), eps=1e-8))


def init_state(cfg, num_frames: int, device=None,
               models: Optional[Tuple] = None) -> Stage2State:
    """A fresh run: the config's models (or ``models``), zero latent codes,
    g_ema a copy of G, the three optimizers, on ``device`` (default: the
    CUDA device; raises without one)."""
    device = resolve_device(device)
    renderer, generator, discriminator = models or build_models(cfg)
    renderer = renderer.to(device).train()
    generator = generator.to(device).train()
    discriminator = discriminator.to(device).train()
    g_ema = copy.deepcopy(generator).eval().requires_grad_(False)
    latent_codes = torch.nn.Parameter(torch.zeros(
        num_frames, cfg.experiment.latent_code_dim, device=device))
    opts = make_optimizers(
        cfg, list(renderer.parameters()) + [latent_codes],
        list(generator.parameters()), list(discriminator.parameters()))
    return Stage2State(renderer, latent_codes, generator, discriminator,
                       g_ema, *opts)


def sample_styles(rng: torch.Generator, generator: StyleUNetSR, batch: int,
                  gan, device) -> StyleDraws:
    """Two style codes, the mixing decision (probability ``gan.mixing``)
    and its layer, and the StyledConvs' noise, from ``rng``."""
    kw = dict(generator=rng, device=device)
    z = torch.randn(2, batch, gan.latent, **kw)
    mix = float(torch.rand((), **kw)) < gan.mixing
    idx = int(torch.randint(1, generator.n_latent, (), **kw))
    return StyleDraws(z[0], z[1], idx if mix else generator.n_latent,
                      generator.draw_noise(batch, rng, device))


@contextlib.contextmanager
def frozen(module: torch.nn.Module):
    """``module``'s parameters take no gradient inside the block (the
    reference's ``requires_grad(net, False)``)."""
    flags = [p.requires_grad for p in module.parameters()]
    module.requires_grad_(False)
    try:
        yield
    finally:
        for p, f in zip(module.parameters(), flags):
            p.requires_grad_(f)


def nchw(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 3, 1, 2)


def render_image(renderer: AvatarRenderer, latent_codes: torch.Tensor,
                 batch, num_coarse: int, num_fine: int, *,
                 perturb: bool = False, noise_std: float = 0.0, rng=None,
                 mesh=None):
    """The render [B, s, s, 3 + C] and its opacity [B, s, s, 1] of the
    batch's rays. With ``mesh``, ``batch`` holds this rank's block of the
    rays, ``rng`` is this rank's randomness, and the outputs are
    all-gathered to the whole image's."""
    rays = batch["mv_rays"]
    out = renderer(
        rays[..., :8], rays[..., 8:11], latent_codes[batch["dataset_idx"]],
        batch["inv_head_T"], batch["front_render_cond"],
        batch["left_render_cond"], batch["right_render_cond"],
        num_coarse=num_coarse, num_fine=num_fine, perturb=perturb,
        radiance_field_noise_std=noise_std, rng=rng)
    fine = out["rgb_fine"] is not None
    rgb = out["rgb_fine"] if fine else out["rgb_coarse"]
    acc = out["acc_fine"] if fine else out["acc_coarse"]
    if mesh_rank_size(mesh)[1] > 1:
        group = mesh.get_group()
        rgb = comm.all_gather(rgb, 1, group)
        acc = comm.all_gather(acc, 1, group)
    B, s = rgb.shape[0], renderer.render_size
    return rgb.reshape(B, s, s, -1), acc.reshape(B, s, s, 1)


def make_steps(state: Stage2State, cfg, lpips_params: Optional[Any] = None,
               mesh=None) -> Tuple[Callable, Callable, Callable, Callable]:
    """(d_step, r1_step, g_step, dg_step): each updates ``state`` in place
    and returns its metrics, detached. d_step, g_step and dg_step take
    (batch, rng), r1_step (batch); ``batch`` holds the loader's tensors plus
    ``gt_hr_img`` [B, 512, 512, 3] and ``gt_lr_mask`` [B, 128, 128, 1]
    (``cli/train_avatarHD.py:prepare_batch``).

    ``mesh``: ``batch`` holds this rank's block of the rays (``mv_rays``,
    ``gt_color`` [B, R / N, ...]; the images whole); ``rng`` is a
    generator (the same on every rank) or the draws of the whole batch."""
    gan, nerf_cfg = cfg.gan, cfg.nerf.train
    render_size = cfg.models.StyleUnet.inp_size
    gen_size = cfg.models.StyleUnet.out_size
    mask_weight = cfg.experiment.mask_weight
    renderer, gen, disc = state.renderer, state.generator, state.discriminator
    nerf_params = list(renderer.parameters()) + [state.latent_codes]
    group = None if mesh is None else mesh.get_group()

    def average(*modules_or_params) -> None:
        """The gradients of the given modules and parameter lists, averaged
        over the ranks."""
        if mesh is None:
            return
        params = []
        for m in modules_or_params:
            params += (list(m.parameters())
                       if isinstance(m, torch.nn.Module) else m)
        comm.all_reduce_grads(params, group=group)

    def draws(rng: Rng, batch) -> Stage2Draws:
        """The step's draws, in the span ``draws`` (it holds
        ``sample_styles``' two host reads)."""
        with span("draws"):
            rays = batch["mv_rays"]
            if isinstance(rng, Stage2Draws):
                return Stage2Draws(rank_rng(rng.render, rays, False, mesh),
                                   rng.styles)
            B, R = rays.shape[:2]
            render = draw_render_noise(
                rank_rng(rng, rays, False, mesh), B, R, nerf_cfg.num_coarse,
                nerf_cfg.num_fine, bool(nerf_cfg.perturb),
                float(nerf_cfg.radiance_field_noise_std), rays.device,
                rays.dtype)
            return Stage2Draws(render, sample_styles(rng, gen, B, gan,
                                                     rays.device))

    def render_full(batch, noise: RenderNoise):
        render, mask = render_image(
            renderer, state.latent_codes, batch, nerf_cfg.num_coarse,
            nerf_cfg.num_fine, perturb=bool(nerf_cfg.perturb),
            noise_std=float(nerf_cfg.radiance_field_noise_std), rng=noise,
            mesh=mesh)
        latent = state.latent_codes[batch["dataset_idx"]]
        return render, mask, latent_code_loss(state.latent_codes, latent)

    def generate(render, s: StyleDraws):
        return gen([s.z0, s.z1], nchw(render[..., 3:]), noise=s.noise,
                 inject_index=s.inject_index)

    def d_loss(fake_img, gt_hr):
        fake_pred, real_pred = disc(fake_img), disc(nchw(gt_hr))
        loss = L.d_logistic_loss(real_pred, fake_pred)
        return loss, {"d": loss, "real_score": real_pred.mean(),
                      "fake_score": fake_pred.mean()}

    def g_loss(batch, dr: Stage2Draws):
        """The G objective on a render with gradients -> (total, metrics,
        fake image)."""
        gt_hr = batch["gt_hr_img"]
        gt_lr_up = L.downsample_bilinear(
            L.downsample_bilinear(gt_hr, render_size), gen_size)
        render, mask, code_loss = render_full(batch, dr.render)
        lr_up = L.downsample_bilinear(render[..., :3], gen_size)
        rgb_loss = (lr_up - gt_lr_up).square().mean()
        nerf_loss = rgb_loss + code_loss
        mask_loss = torch.zeros((), device=gt_hr.device)
        if mask_weight > 0:
            mask_loss = L.binary_cross_entropy(mask, batch["gt_lr_mask"])
            nerf_loss = nerf_loss + mask_weight * mask_loss
        fake_img = generate(render, dr.styles)
        with frozen(disc):
            adv = L.g_nonsaturating_loss(disc(fake_img))
        gt_nchw = nchw(gt_hr)
        hr_l1 = (fake_img - gt_nchw).abs().mean()
        total = nerf_loss + adv * L.gan_loss_weight(state.step) + hr_l1
        percep = torch.zeros((), device=gt_hr.device)
        if lpips_params is not None:
            percep = lpips_loss(lpips_params, fake_img.permute(0, 2, 3, 1),
                                gt_hr)
            total = total + 0.1 * percep
        metrics = {"rgb_loss": rgb_loss, "mask_loss": mask_loss,
                   "code_loss": code_loss, "nerf_loss": nerf_loss, "g": adv,
                   "hr_l1": hr_l1, "percep": percep,
                   "psnr": L.mse2psnr(rgb_loss),
                   "SR_psnr": L.mse2psnr(
                       (fake_img - gt_nchw).square().mean())}
        return total, metrics, fake_img

    def g_update():
        with span("optim"):
            state.nerf_opt.step()
            state.g_opt.step()
            ema_update(state.g_ema, gen, EMA_DECAY)
        state.step += 1

    def detached(m: Metrics) -> Metrics:
        return {k: v.detach() for k, v in m.items()}

    def d_step(batch, rng: Rng) -> Metrics:
        dr = draws(rng, batch)
        with torch.no_grad():
            render, _, _ = render_full(batch, dr.render)
            fake_img = generate(render, dr.styles)
        state.d_opt.zero_grad(set_to_none=True)
        loss, metrics = d_loss(fake_img, batch["gt_hr_img"])
        with span("backward"):
            (loss * L.gan_loss_weight(state.step)).backward()
        average(disc)
        with span("optim"):
            state.d_opt.step()
        return detached(metrics)

    def r1_step(batch) -> Metrics:
        state.d_opt.zero_grad(set_to_none=True)
        r1 = L.d_r1_penalty(disc, nchw(batch["gt_hr_img"]))
        with span("backward"):
            ((gan.r1 / 2.0) * r1 * L.gan_loss_weight(state.step)
             * gan.d_reg_every).backward()
        average(disc)
        with span("optim"):
            state.d_opt.step()
        return {"r1": r1.detach()}

    def g_step(batch, rng: Rng) -> Metrics:
        dr = draws(rng, batch)
        state.nerf_opt.zero_grad(set_to_none=True)
        state.g_opt.zero_grad(set_to_none=True)
        total, metrics, _ = g_loss(batch, dr)
        with span("backward"):
            total.backward()
        average(nerf_params, gen)
        g_update()
        return detached(metrics)

    def dg_step(batch, rng: Rng) -> Metrics:
        dr = draws(rng, batch)
        for opt in (state.nerf_opt, state.g_opt, state.d_opt):
            opt.zero_grad(set_to_none=True)
        total, metrics, fake_img = g_loss(batch, dr)
        with span("backward"):
            total.backward()
        # D's loss on the same image, on D before this step's update
        loss, d_metrics = d_loss(fake_img.detach(), batch["gt_hr_img"])
        with span("backward"):
            (loss * L.gan_loss_weight(state.step)).backward()
        average(nerf_params, gen, disc)
        with span("optim"):
            state.d_opt.step()
        g_update()
        return detached({**metrics, **d_metrics})

    return d_step, r1_step, g_step, dg_step
