"""Stage-1 NeRF training: the renderer, its loss, a training step and the
skinning volume's pretraining.

Port of ``havatar_tpu/train/stage1.py``. ``build_renderer`` is the one place
that turns a config into an ``AvatarRenderer`` (inference uses it too).
Training keeps per-frame latent codes beside the renderer; the loss is
coarse + fine colour error, BCE of the accumulated opacity against the ray
mask, an optional patch LPIPS term, a pull of the chosen codes towards the
mean code and the total variation of the skinning weights; the optimizer is
Adam with an exponentially decayed learning rate that has a floor.

Where the JAX trainer threads a PRNG key through its jitted step, this one
takes a ``torch.Generator`` (or, from a test, the draws themselves: see
``models/renderer.py:RenderNoise``).

On several GPUs (``mesh``: one process a GPU, ``parallel/``) each rank gets
its block of the batch. Split on the rays (the JAX package's ``shard_map``
route), a rank generates the planes, renders its rays, and the outputs the
loss reads are all-gathered, so every rank computes JAX's loss on the
global tensors; the gather's backward sums each block's gradient over the
ranks, and averaging the parameter gradients (``comm.all_reduce_grads``)
then gives the global loss's gradient exactly, replicated terms (the code
loss, the skinning TV) counted once. Split on the frames
(``frame_parallel``: the world size divides the batch), a rank's loss is
over its frames and the gradients are averaged. A rank's sample noise comes
from a generator with its rank folded in, or, given the draws of all rays,
from its block of them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch

from havatar_tpu_torch.device import resolve_device
from havatar_tpu_torch.models.renderer import (
    AvatarRenderer,
    RenderNoise,
    latent_code_loss,
    shard_render_noise,
)
from havatar_tpu_torch.models.skinning import make_volume_pts
from havatar_tpu_torch.parallel import comm
from havatar_tpu_torch.parallel.mesh import mesh_rank_size
from havatar_tpu_torch.train import losses as L
from havatar_tpu_torch.train.lpips import lpips_loss
from havatar_tpu_torch.utils.profiling import span

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
        # the fused dense chain (forward and backward CUDA kernels,
        # ops/mlp.py), and the fused gather + corner reduction + chain
        # (ops/mlp_quad.py), which takes precedence; the keys are the JAX
        # package's, so one config file serves both
        use_fused_mlp=bool(cfg.models.get("use_pallas_mlp", False)),
        use_fused_quad=bool(cfg.models.get("use_pallas_mlp_quad", False)),
    )
    kw.update(overrides)
    return AvatarRenderer(**kw)


@dataclass
class TrainState:
    """What a stage-1 run carries: the renderer, the per-frame latent codes
    [num_frames, latent_code_dim], their optimizer and the number of
    finished steps."""
    renderer: AvatarRenderer
    latent_codes: torch.nn.Parameter
    optimizer: torch.optim.Optimizer
    step: int = 0


def make_optimizer(cfg, params) -> torch.optim.Adam:
    """Adam (eps 1e-8) over ``params``; its learning rate is set every step
    by ``learning_rate``."""
    return torch.optim.Adam(params, lr=cfg.optimizer.lr, eps=1e-8)


def learning_rate(cfg, step: int) -> float:
    """The decayed rate for the update that follows ``step`` finished steps
    (the count starts at 0, as optax's schedules count)."""
    return L.stage1_lr(step, base_lr=cfg.optimizer.lr,
                       decay_factor=cfg.scheduler.lr_decay_factor,
                       decay_kilosteps=cfg.scheduler.lr_decay,
                       floor=cfg.scheduler.get("lr_floor", 5e-5))


def init_state(cfg, num_frames: int, device=None,
               renderer: Optional[AvatarRenderer] = None) -> TrainState:
    """A fresh run: the config's renderer (or ``renderer``), zero latent
    codes and an optimizer over both, on ``device`` (default: the CUDA
    device; raises without one)."""
    device = resolve_device(device)
    renderer = (build_renderer(cfg) if renderer is None else renderer)
    renderer = renderer.to(device).train()
    latent_codes = torch.nn.Parameter(torch.zeros(
        num_frames, cfg.experiment.latent_code_dim, device=device))
    opt = make_optimizer(cfg, list(renderer.parameters()) + [latent_codes])
    return TrainState(renderer, latent_codes, opt, 0)


Rng = Union[None, torch.Generator, RenderNoise]


def rank_rng(rng: Rng, rays: torch.Tensor, frame_parallel: bool, mesh
             ) -> Rng:
    """This rank's randomness for a render of its block ``rays`` [B, R, C]
    of the batch (split on the frames or on the rays): its part of draws
    made for all rays, or a generator with its rank folded in."""
    rank, world = mesh_rank_size(mesh)
    if world == 1 or rng is None:
        return rng
    if isinstance(rng, RenderNoise):
        B, R = rays.shape[:2]
        axis = 0 if frame_parallel else 1
        B, R = (B * world, R) if frame_parallel else (B, R * world)
        return shard_render_noise(rng, B, R, axis, rank, world)
    return comm.fold_in(rng, rank)


def reduce_metrics(metrics: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
    """Metrics of this rank's frames -> their mean over the ranks, a PSNR
    averaged as its MSE."""
    if comm.get_world_size() == 1:
        return metrics
    mse = {k: 10.0 ** (-v.detach() / 10.0) if k.endswith("psnr") else v
           for k, v in metrics.items()}
    mean = comm.reduce_loss_dict(mse)
    return {k: L.mse2psnr(v) if k.endswith("psnr") else v
            for k, v in mean.items()}


# the render's outputs that the loss reads: all-gathered on the ray axis
GATHERED = ("rgb_coarse", "acc_coarse", "rgb_fine", "acc_fine")


def make_loss_fn(renderer: AvatarRenderer, cfg,
                 lpips_params: Optional[Any] = None, mesh=None,
                 frame_parallel: bool = False
                 ) -> Callable[..., Tuple[torch.Tensor, Dict[str, torch.Tensor]]]:
    """The stage-1 loss as fn(latent_codes, batch, rng) -> (loss, metrics).
    Public so that a test can compare raw gradients: parameters after the
    first Adam step do not depend on the gradient's scale.

    ``mesh`` (``parallel.make_mesh``): ``batch`` is this rank's block,
    split on the rays (``mv_rays`` and ``gt_color`` [B, R / N, ...], the
    rest whole) or, with ``frame_parallel``, on the frames; ``rng`` is a
    generator (the same on every rank) or the draws of all rays. The
    metrics are the global ones on every rank; the loss is the global one
    on the rays, this rank's frames' with ``frame_parallel``."""
    nerf_cfg = cfg.nerf.train
    mask_weight = cfg.experiment.mask_weight
    use_patch = (bool(cfg.experiment.get("patch_rgb", False))
                 and lpips_params is not None)
    use_l1 = cfg.experiment.rgb_loss != "mse"
    group = None if mesh is None else mesh.get_group()
    ray_sharded = mesh_rank_size(mesh)[1] > 1 and not frame_parallel

    def rgb_loss_fn(a, b):
        return (a - b).abs().mean() if use_l1 else (a - b).square().mean()

    def loss_fn(latent_codes: torch.Tensor, batch: Dict[str, torch.Tensor],
                rng: Rng):
        rays = batch["mv_rays"]
        latent = latent_codes[batch["dataset_idx"]]
        out = renderer(
            rays[..., :8], rays[..., 8:11], latent, batch["inv_head_T"],
            batch["front_render_cond"], batch["left_render_cond"],
            batch["right_render_cond"],
            num_coarse=nerf_cfg.num_coarse, num_fine=nerf_cfg.num_fine,
            perturb=bool(nerf_cfg.perturb),
            radiance_field_noise_std=float(nerf_cfg.radiance_field_noise_std),
            rng=rank_rng(rng, rays, frame_parallel, mesh))
        target, ray_mask = batch["gt_color"], rays[..., -1:]
        if ray_sharded:
            out = {k: comm.all_gather(v, 1, group)
                   if k in GATHERED and v is not None else v
                   for k, v in out.items()}
            target = comm.all_gather(target, 1, group)
            ray_mask = comm.all_gather(ray_mask, 1, group)

        coarse_loss = rgb_loss_fn(out["rgb_coarse"][..., :3], target)
        mask_coarse = L.binary_cross_entropy(out["acc_coarse"], ray_mask)
        loss = coarse_loss + mask_weight * mask_coarse
        metrics = {"coarse_loss": coarse_loss,
                   "mask_coarse_loss": mask_coarse}
        rgb = out["rgb_coarse"][..., :3]
        if out["rgb_fine"] is not None:
            rgb = out["rgb_fine"][..., :3]
            fine_loss = rgb_loss_fn(rgb, target)
            mask_fine = L.binary_cross_entropy(out["acc_fine"], ray_mask)
            loss = loss + fine_loss + mask_weight * mask_fine
            metrics["fine_loss"] = fine_loss
            metrics["mask_fine_loss"] = mask_fine
        psnr_mse = (rgb - target).square().mean()

        if use_patch:
            B, R = rgb.shape[:2]
            ps = int(R ** 0.5)
            patch_loss = lpips_loss(lpips_params, rgb.reshape(B, ps, ps, 3),
                                    target.reshape(B, ps, ps, 3))
            loss = loss + 0.05 * patch_loss
            metrics["patch_percep_loss"] = patch_loss

        code_loss = latent_code_loss(latent_codes, latent)
        loss = loss + code_loss

        # total variation of the head-follow skinning weights
        sw_loss = L.skin_weight_tv_loss(renderer.skin_volume()[0, 1])
        loss = loss + 1e-4 * sw_loss

        metrics.update({"loss": loss, "code_loss": code_loss,
                        "sw_grad_loss": sw_loss,
                        "psnr": L.mse2psnr(psnr_mse)})
        if frame_parallel:
            metrics = reduce_metrics(metrics)
        return loss, metrics

    return loss_fn


def make_train_step(state: TrainState, cfg,
                    lpips_params: Optional[Any] = None, mesh=None,
                    frame_parallel: bool = False):
    """Returns train_step(batch, rng) -> metrics (detached tensors): one
    forward, backward and Adam update of ``state``, in place. ``mesh`` and
    ``frame_parallel`` as ``make_loss_fn``'s; the gradients are averaged
    over the ranks before the update, which every rank then makes alike."""
    loss_fn = make_loss_fn(state.renderer, cfg, lpips_params, mesh,
                           frame_parallel)
    params = list(state.renderer.parameters()) + [state.latent_codes]
    group = None if mesh is None else mesh.get_group()

    def train_step(batch: Dict[str, torch.Tensor], rng: Rng):
        state.optimizer.zero_grad(set_to_none=True)
        loss, metrics = loss_fn(state.latent_codes, batch, rng)
        with span("backward"):
            loss.backward()
        if mesh is not None:
            comm.all_reduce_grads(params, group=group)
        with span("optim"):
            lr = learning_rate(cfg, state.step)
            for pg in state.optimizer.param_groups:
                pg["lr"] = lr
            state.optimizer.step()
        state.step += 1
        return {k: v.detach() for k, v in metrics.items()}

    return train_step


# ---------------------------------------------------------------------------
# Skinning-volume pretraining: BCE-fit the head-follow weight channel to a
# box prior (inside ``head_bounding``: 1) before the first training step.
# ---------------------------------------------------------------------------

def pretrain_loss(renderer: AvatarRenderer, head_bounding,
                  jitter: Optional[torch.Tensor], steps: int = 20
                  ) -> torch.Tensor:
    """One iteration's loss: the weight volume sampled at a jittered grid
    (``jitter``: uniform draws [steps^3, 3]) against the box indicator."""
    skin = renderer.headpose_skin_net
    device = skin.canonical_Wvolume.init_lc.device
    thr = torch.as_tensor(head_bounding, dtype=torch.float32, device=device)
    pts = make_volume_pts(steps=steps, jitter=jitter, warp=skin.warp,
                          device=device)
    inside = ((pts > thr[:, 0]) & (pts < thr[:, 1])).all(-1)
    target = inside.float()[:, None]
    w = skin.sample_weight(pts).clamp(0.0, 1.0)
    return L.binary_cross_entropy(w, target, clip=(1e-7, 1 - 1e-7))


def pretrain_skinning(renderer: AvatarRenderer, rng: torch.Generator,
                      head_bounding, num_iter: int = 3000, lr: float = 1e-3,
                      steps: int = 20) -> List[float]:
    """Adam (``lr``) on the volume decoder alone, fresh jittered grid points
    every iteration. Updates ``renderer`` in place; returns the loss
    history."""
    skin = renderer.headpose_skin_net
    params = list(skin.canonical_Wvolume.parameters())
    device = params[0].device
    opt = torch.optim.Adam(params, lr=lr, eps=1e-8)
    history = []
    for _ in range(num_iter):
        jitter = torch.rand(steps ** 3, 3, generator=rng, device=device)
        opt.zero_grad(set_to_none=True)
        loss = pretrain_loss(renderer, head_bounding, jitter, steps)
        loss.backward()
        opt.step()
        history.append(loss.detach())
    return [float(v) for v in torch.stack(history).cpu()] if history else []
