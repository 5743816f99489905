"""Reenactment inference: the per-frame pipeline, the offline loop that
renders a driving split to PNG frames, and the flagship model.

Port of ``havatar_tpu/infer/reenact.py`` (``make_reenact_fn``,
``mean_style``, ``run_reenactment``) and of the bench flagship
(``__graft_entry__.py:_build_flagship``): two plane generators (256^2
conditions -> 128^2 x 64 planes), the gated march (16 coarse + 16 fine
samples a ray by default), and StyleUNetSR lifting the 128^2 feature image
to 512^2 RGB.

Which renderer configuration runs (``models/renderer.py`` lists the three):
``run_reenactment`` builds the fused march on raw corner rows for
``precision="fast"`` and the exact float32 path for ``"exact"``;
``build_flagship`` builds the fused march, on raw corner rows unless
``use_quad_march=False`` asks for the reduced-input kernels.

Public layout is the JAX package's: rays [B, R, 8], bg [B, R, 3],
latent [B, 32], inv_head_T [B, 4, 3], conditions NHWC [B, 256, 256, 7],
frames NHWC [B, 512, 512, 3].
"""

from __future__ import annotations

import contextlib
import math
import os
import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch
import torch.nn as nn

from havatar_tpu_torch.device import DeviceLike, resolve_device
from havatar_tpu_torch.models.blocks import (
    ConstantInput,
    EqualConv2d,
    EqualLinear,
    ModulatedConv2d,
)
from havatar_tpu_torch.models.generators import StyleUNetSR
from havatar_tpu_torch.models.renderer import AvatarRenderer
from havatar_tpu_torch.models.skinning import (
    VolumeDecoder,
    fix_canonical_volume,
)
from havatar_tpu_torch.ops.rays import get_rays_np, tighten_ray_near_far
from havatar_tpu_torch.parallel import comm
from havatar_tpu_torch.parallel.mesh import local_shard, make_mesh, ray_sharding


def mean_style(style_dim: int, n: int = 1000, seed: int = 42,
               device: DeviceLike = None) -> torch.Tensor:
    """Mean of n raw normal latents [1, style_dim] (mapped inside the
    generator at call time), drawn from a seeded ``torch.Generator``."""
    dev = resolve_device(device)
    g = torch.Generator(device="cpu").manual_seed(seed)
    return torch.randn(n, 1, style_dim, generator=g).mean(0).to(dev)


def super_resolve(generator: Optional[StyleUNetSR], style: torch.Tensor,
                  render: torch.Tensor, to_uint8: bool) -> torch.Tensor:
    """The generator's frame [B, H, W, 3] of the render [B, s, s, 3 + C]
    (its features) for ``style`` [1 or B, D]: uint8, or float in [0, 1]
    scale; the render itself when ``generator`` is None."""
    if generator is None:
        return render
    style_b = style.expand(render.shape[0], style.shape[-1])
    img = generator(style_b, render[..., 3:].permute(0, 3, 1, 2))
    img = img.permute(0, 2, 3, 1)
    if to_uint8:
        img = torch.clamp(img * 255.0, 0.0, 255.0).to(torch.uint8)
    return img


def make_reenact_fn(renderer: AvatarRenderer,
                    generator: Optional[StyleUNetSR], *,
                    num_coarse: int = 64, num_fine: int = 16,
                    gated: bool = False, to_uint8: bool = True) -> Callable:
    """The per-frame pipeline: (fixed_volume, style, rays, bg, latent,
    inv_head_T, front, left, right) -> frame [B, H, W, 3], uint8 or (with
    ``to_uint8=False``) float in [0, 1] scale; the feature render
    [B, s, s, 3 + C] without a ``generator``.

    ``gated`` cuts each ray's near/far to the avatar's world AABB plus the
    one-texel halo (``renderer.gate_aabb``) before the march; pair it with
    a smaller ``num_coarse``.
    """
    def frame_fn(fixed_volume, style, rays, bg, latent, inv_head_T, front,
                 left, right):
        with torch.inference_mode():
            if gated:
                rays = tighten_ray_near_far(rays, renderer.gate_aabb,
                                            inv_head_T)
            render, _ = renderer.render_full_image(
                rays, bg, latent, inv_head_T, front, left, right,
                num_coarse=num_coarse, num_fine=num_fine,
                fixed_volume=fixed_volume)
            return super_resolve(generator, style, render, to_uint8)

    return frame_fn


@contextlib.contextmanager
def _full_float32():
    """TF32 off for convolutions and matmuls (cuDNN convolutions take TF32
    by default, which keeps about three decimal digits)."""
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev


def run_reenactment(cfg, split_file: str, savedir: str, variables,
                    latent_codes, g_ema_params, seed: int = 42,
                    max_frames: Optional[int] = None,
                    pipeline_depth: int = 3, precision: str = "auto",
                    gated: bool = False, num_coarse: Optional[int] = None,
                    device: DeviceLike = None) -> Optional[Dict[str, Any]]:
    """Offline reenactment loop: renders every (frame, view) item of the
    driving split to ``savedir/rgb/{fidx}_{vidx:02d}.png``. Returns timing
    stats {"frames", "seconds", "fps", "ray_cache_entries"}.

    ``variables`` is the renderer's ``state_dict`` (without latent codes),
    ``latent_codes`` a [N, D] tensor, ``g_ema_params`` the StyleUNet's
    ``state_dict``. ``precision``: "fast" is bf16 compute, the fused march
    kernels and a bf16 skinning volume; "exact" the float32 path with TF32
    off; "auto" is fast on CUDA and exact on the CPU. ``gated`` tightens
    each ray's near/far to the avatar's box, usually with a smaller
    ``num_coarse`` (None: the config's).

    The loop is pipelined: a prefetch thread decodes conditions and copies
    them to the device, ``pipeline_depth`` frames are launched before the
    first blocking readback (on CUDA each uint8 frame goes to a pinned
    buffer with a non-blocking copy and an event, drained in order), and
    rays are cached per view and per ray bytes (a camera may move between
    frames, so the view index alone is no safe key).

    Under a process group of N ranks (``torchrun``; ``parallel.comm``)
    each frame's ray axis is split over the ranks
    (``serving.make_sharded_frame_fn``): the ray cache holds this rank's
    block of each camera's rays and background, only the primary rank
    writes the PNGs and returns the stats, and the others return None
    after the last frame's collective.
    """
    from havatar_tpu_torch.data import AvatarDataset, Loader, device_prefetch
    from havatar_tpu_torch.data.image_io import imwrite_rgb
    from havatar_tpu_torch.train.stage1 import build_renderer

    dev = resolve_device(device)
    mesh = make_mesh(("data",), dev) if comm.get_world_size() > 1 else None
    spec = None if mesh is None else ray_sharding(mesh)
    primary = comm.is_primary()
    if precision == "auto":
        precision = "fast" if dev.type == "cuda" else "exact"
    if precision == "fast":
        renderer = build_renderer(cfg, compute_dtype=torch.bfloat16,
                                  skin_compute_dtype=None,
                                  use_fused_march=True)
    elif precision == "exact":
        renderer = build_renderer(cfg)
    else:
        raise ValueError(f"precision must be auto, fast or exact, "
                         f"got {precision!r}")
    gan, sr = cfg.gan, cfg.models.StyleUnet
    generator = StyleUNetSR(
        inp_size=sr.inp_size, inp_ch=sr.inp_ch, out_ch=3,
        out_size=sr.out_size, style_dim=gan.latent, n_mlp=gan.n_mlp,
        channel_multiplier=gan.channel_multiplier,
        compute_dtype=renderer.compute_dtype)
    renderer.load_state_dict(variables)
    generator.load_state_dict(g_ema_params)
    renderer, generator = renderer.to(dev).eval(), generator.to(dev).eval()

    if primary:
        os.makedirs(os.path.join(savedir, "rgb"), exist_ok=True)
    style = mean_style(generator.style_dim, seed=seed, device=dev)
    with torch.inference_mode():
        fixed_volume = fix_canonical_volume(renderer.skin_volume())
    nerf_cfg = cfg.nerf.validation
    march = dict(gated=gated, num_fine=int(nerf_cfg.num_fine),
                 num_coarse=int(num_coarse if num_coarse is not None
                                else nerf_cfg.num_coarse))
    if mesh is None:
        frame_fn = make_reenact_fn(renderer, generator, **march)
    else:
        from havatar_tpu_torch.infer.serving import make_sharded_frame_fn
        frame_fn = make_sharded_frame_fn(mesh, renderer, generator,
                                         to_uint8=True, **march)

    ds = AvatarDataset(split_file, mode="test", cfg=cfg,
                       down_sample=cfg.dataset.down_sample, full_image=True)
    loader = Loader(ds, batch_size=1, shuffle=False, num_workers=2)
    # mv_rays stays on the host so that the ray cache can hash it
    keep = {"inv_head_T", "front_render_cond", "left_render_cond",
            "right_render_cond"}
    batches = device_prefetch(iter(loader), size=pipeline_depth, device=dev,
                              keys=keep)

    latent = torch.as_tensor(latent_codes)[0:1].float().to(dev)
    ray_cache: Dict[Any, Any] = {}
    pending: List[Any] = []
    host_ring: List[torch.Tensor] = []      # pinned readback buffers
    n = 0
    t0 = time.perf_counter()

    def read_back(img: torch.Tensor):
        """uint8 frame [1, H, W, 3] -> (host tensor, event or None)."""
        if dev.type != "cuda":
            return img, None
        if len(host_ring) <= pipeline_depth:
            host_ring.append(torch.empty(img.shape, dtype=img.dtype,
                                         pin_memory=True))
        host = host_ring[n % (pipeline_depth + 1)]
        host.copy_(img, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return host, event

    def drain(limit: int) -> None:
        while len(pending) > limit:
            host, event, name = pending.pop(0)
            if event is not None:
                event.synchronize()
            imwrite_rgb(os.path.join(savedir, "rgb", name),
                        host[0].numpy())

    with contextlib.ExitStack() as stack:
        if precision == "exact":
            stack.enter_context(_full_float32())
        for batch in batches:
            if max_frames is not None and n >= max_frames:
                break
            host_rays = np.asarray(batch["mv_rays"])
            key = (int(batch["vidx"][0]), hash(host_rays.tobytes()))
            cached = ray_cache.get(key)
            if cached is None:
                rays, bg = (torch.from_numpy(np.ascontiguousarray(
                    local_shard(host_rays[..., a:b], spec))).to(dev)
                    for a, b in ((0, 8), (8, 11)))
                if len(ray_cache) > 64:   # freeview: each frame a new camera
                    ray_cache.clear()
                ray_cache[key] = (rays, bg)
            else:
                rays, bg = cached
            img = frame_fn(fixed_volume, style, rays, bg, latent,
                           batch["inv_head_T"], batch["front_render_cond"],
                           batch["left_render_cond"],
                           batch["right_render_cond"])
            if primary:
                name = f"{batch['fidx'][0]}_{batch['vidx'][0]:02d}.png"
                pending.append((*read_back(img), name))
                drain(pipeline_depth)
            n += 1
        drain(0)
    if mesh is not None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        comm.synchronize()
    t_total = time.perf_counter() - t0
    if not primary:
        return None
    return {"frames": n, "seconds": t_total,
            "fps": n / t_total if t_total > 0 else 0.0,
            "ray_cache_entries": len(ray_cache)}


@torch.no_grad()
def seeded_init_(module: nn.Module, seed: int) -> nn.Module:
    """Re-draw every random parameter of ``module`` from a numpy seed, with
    the JAX package's initializers: N(0, 1) for equalized-lr weights
    (EqualLinear's divided by lr_mul) and constant inputs, LeCun normal for
    the field's dense layers, Xavier normal for the volume decoder's convs,
    U(0, 1) for its seed. Constant initializations (biases) stay."""
    rng = np.random.RandomState(seed)

    def normal(shape, std=1.0):
        return torch.from_numpy(
            (rng.standard_normal(shape) * std).astype(np.float32))

    for m in module.modules():
        if isinstance(m, EqualLinear):
            m.weight.copy_(normal(m.weight.shape) / m.lr_mul)
        elif isinstance(m, (EqualConv2d, ModulatedConv2d)):
            m.weight.copy_(normal(m.weight.shape))
        elif isinstance(m, ConstantInput):
            m.input.copy_(normal(m.input.shape))
        elif isinstance(m, nn.Linear):
            m.weight.copy_(normal(m.weight.shape, 1 / math.sqrt(m.in_features)))
            m.bias.zero_()
        elif isinstance(m, nn.Conv3d):
            fan_in = m.weight[0].numel()
            fan_out = m.weight.shape[0] * m.weight[0, 0].numel()
            m.weight.copy_(normal(m.weight.shape,
                                  math.sqrt(2.0 / (fan_in + fan_out))))
            m.bias.zero_()
        elif isinstance(m, VolumeDecoder):
            m.init_lc.copy_(torch.from_numpy(
                rng.rand(*m.init_lc.shape).astype(np.float32)))
    return module


class Flagship(NamedTuple):
    frame_fn: Callable
    renderer: AvatarRenderer
    generator: StyleUNetSR
    inputs: Dict[str, torch.Tensor]   # frame_fn's keyword arguments


def flagship_rays(render_size: int = 128) -> np.ndarray:
    """The flagship's portrait camera: at (0, -0.1, 3) looking down -z,
    focal 1.2 * render_size, near/far 1.4/4.0 -> rays [1, R, 8]."""
    c2w = np.array([[1.0, 0.0, 0.0, 0.0],
                    [0.0, -1.0, 0.0, -0.1],
                    [0.0, 0.0, -1.0, 3.0]], dtype=np.float32)
    ro, rd = get_rays_np(render_size, render_size,
                         (1.2 * render_size, 1.2 * render_size, 0.5, 0.5),
                         c2w)
    R = render_size * render_size
    return np.concatenate([ro.reshape(1, R, 3), rd.reshape(1, R, 3),
                           np.full((1, R, 1), 1.4, np.float32),
                           np.full((1, R, 1), 4.0, np.float32)], -1)


def build_flagship(device: DeviceLike = None, seed: int = 0,
                   num_coarse: int = 16, num_fine: int = 16,
                   gated: bool = True, render_size: int = 128,
                   cond_res: int = 256, plane_res: int = 128,
                   plane_middle_size: int = 16, sr_out: int = 512,
                   use_quad_march: bool = True, mesh=None) -> Flagship:
    """The flagship reenactment model in bf16 with weights drawn from
    ``seed`` (``seeded_init_``) and the flagship's inputs for one frame: its
    camera, white background, zero latent and style, identity head pose and
    0.5 conditions. The renderer is built on the fused march: on raw corner
    rows (``march_coarse`` / ``march_fine``) by default, on the reduced MLP
    input (``march_coarse_x`` / ``march_fine_x``) with
    ``use_quad_march=False``. Sizes default to the full width (the tests
    pass tiny ones); on CUDA unless ``device`` says otherwise. With
    ``mesh`` (``parallel.make_mesh``) the frame is
    ``serving.make_sharded_frame_fn``'s and ``inputs`` holds this rank's
    block of the rays and background."""
    dev = resolve_device(device)
    renderer = AvatarRenderer(render_size=render_size, cond_res=cond_res,
                              plane_res=plane_res,
                              plane_middle_size=plane_middle_size,
                              compute_dtype=torch.bfloat16,
                              use_fused_march=True,
                              use_quad_march=use_quad_march)
    generator = StyleUNetSR(inp_size=render_size, inp_ch=64, out_ch=3,
                            out_size=sr_out, style_dim=64, n_mlp=4,
                            compute_dtype=torch.bfloat16)
    seeded_init_(renderer, seed)
    seeded_init_(generator, seed + 1)
    renderer = renderer.to(dev).eval()
    generator = generator.to(dev).eval()
    B, R = 1, render_size * render_size
    with torch.inference_mode():
        skin_vol = renderer.skin_volume()
    eye = torch.cat([torch.eye(3), torch.zeros(1, 3)], 0)
    inputs = {
        "fixed_volume": skin_vol,
        "style": torch.zeros(B, 64, device=dev),
        "rays": torch.from_numpy(flagship_rays(render_size)).to(dev),
        "bg": torch.ones(B, R, 3, device=dev),
        "latent": torch.zeros(B, 32, device=dev),
        "inv_head_T": eye.expand(B, 4, 3).contiguous().to(dev),
        **{k: torch.full((B, cond_res, cond_res, 7), 0.5, device=dev)
           for k in ("front", "left", "right")},
    }
    march = dict(num_coarse=num_coarse, num_fine=num_fine, gated=gated,
                 to_uint8=False)
    if mesh is None:
        frame_fn = make_reenact_fn(renderer, generator, **march)
    else:
        from havatar_tpu_torch.infer.serving import (
            make_sharded_frame_fn,
            place_frame_inputs,
        )
        frame_fn = make_sharded_frame_fn(mesh, renderer, generator, **march)
        inputs["rays"], inputs["bg"] = (t.contiguous() for t in
                                        place_frame_inputs(
                                            mesh, inputs["rays"],
                                            inputs["bg"]))
    return Flagship(frame_fn, renderer, generator, inputs)
