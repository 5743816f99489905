"""The one traffic generator: a cell's inputs, made on the device from
(``--seed``, the index of the call or step) and the parameters of its
traffic file (``traffic/<name>.json``).

Every call or step draws from a generator seeded from the run's seed and
its own index, so the inputs of call ``i`` can be made again after the
window for the comparison with the reference, and every seed gives the same
sizes in another order of values.

Rays come from the flagship's portrait camera (at (0, -0.1, 3) looking down
-z, focal 1.2 times the image side, near 1.4 and far 4.0, the stage-1 and
stage-2 datasets' near/far for a camera at that distance). Head poses are
random rotations of up to ``pose_max_angle_rad`` about a random axis and
shifts of up to ``pose_max_shift``; conditions are uniform in [0, 1), new
every frame.
"""

from __future__ import annotations

from typing import Dict

import torch

from h100bench.weights import generator

Inputs = Dict[str, torch.Tensor]
NEAR, FAR = 1.4, 4.0


def camera_rays(side: int, device) -> torch.Tensor:
    """[side * side, 8] rays (origin, unit direction, near, far) of the
    portrait camera over a side x side image, row-major."""
    j, i = torch.meshgrid(torch.arange(side, dtype=torch.float32,
                                       device=device),
                          torch.arange(side, dtype=torch.float32,
                                       device=device), indexing="ij")
    f, c = 1.2 * side, 0.5 * side
    # camera-to-world rotation diag(1, -1, -1), origin (0, -0.1, 3)
    d = torch.stack([(i - c) / f, -(j - c) / f,
                     -torch.ones_like(i)], -1).reshape(-1, 3)
    d = d / d.norm(dim=-1, keepdim=True)
    o = torch.tensor([0.0, -0.1, 3.0], device=device).expand_as(d)
    n = d.shape[0]
    return torch.cat([o, d, torch.full((n, 1), NEAR, device=device),
                      torch.full((n, 1), FAR, device=device)], -1)


def head_pose(g: torch.Generator, B: int, max_angle: float,
              max_shift: float, device) -> torch.Tensor:
    """inv_head_T [B, 4, 3]: a rotation (rows 0-2, right-multiplied) by a
    uniform angle in [-max_angle, max_angle] about a random axis, then a
    translation (row 3) uniform in [-max_shift, max_shift]^3."""
    axis = torch.randn(B, 3, generator=g, device=device)
    axis = axis / axis.norm(dim=-1, keepdim=True)
    angle = (torch.rand(B, 1, 1, generator=g, device=device) * 2 - 1) \
        * max_angle
    k = torch.zeros(B, 3, 3, device=device)
    k[:, 0, 1], k[:, 0, 2] = -axis[:, 2], axis[:, 1]
    k[:, 1, 0], k[:, 1, 2] = axis[:, 2], -axis[:, 0]
    k[:, 2, 0], k[:, 2, 1] = -axis[:, 1], axis[:, 0]
    eye = torch.eye(3, device=device).expand(B, 3, 3)
    rot = eye + torch.sin(angle) * k + (1 - torch.cos(angle)) * (k @ k)
    shift = (torch.rand(B, 1, 3, generator=g, device=device) * 2 - 1) \
        * max_shift
    return torch.cat([rot, shift], 1).contiguous()


def _conditions(g: torch.Generator, B: int, res: int, device) -> Inputs:
    return {k: torch.rand(B, res, res, 7, generator=g, device=device)
            for k in ("front", "left", "right")}


def _mask(g: torch.Generator, B: int, side: int, device) -> torch.Tensor:
    """[B, side, side] head masks: an ellipse with a random centre shift."""
    shift = (torch.rand(B, 2, 1, 1, generator=g, device=device) - 0.5) * 0.2
    y, x = torch.meshgrid(torch.linspace(-1, 1, side, device=device),
                          torch.linspace(-1, 1, side, device=device),
                          indexing="ij")
    return ((((x - shift[:, 0]) / 0.55) ** 2
             + ((y - shift[:, 1]) / 0.75) ** 2) < 1.0).float()


def _train_common(g: torch.Generator, B: int, traffic: Dict, cfg: Dict,
                  device) -> Inputs:
    c = cfg["config"]
    res = c["dataset"]["cond_render_res"]
    cond = _conditions(g, B, res, device)
    return {
        "front_render_cond": cond["front"], "left_render_cond": cond["left"],
        "right_render_cond": cond["right"],
        "inv_head_T": head_pose(g, B, traffic["pose_max_angle_rad"],
                                traffic["pose_max_shift"], device),
        "dataset_idx": torch.randint(0, cfg["assumed"]["num_frames"], (B,),
                                     generator=g, device=device)}


def stage2_batch(seed: int, i: int, traffic: Dict, cfg: Dict,
                 device) -> Inputs:
    """Iteration ``i``'s batch of ``gan.batch`` items: every ray of the
    render-size image (origin, direction, near, far, white background,
    mask), the 512^2 target image ``gt_hr_img`` and the render's mask
    target ``gt_lr_mask``."""
    c = cfg["config"]
    B = c["gan"]["batch"]
    side, out_side = (c["models"]["StyleUnet"]["inp_size"],
                      c["models"]["StyleUnet"]["out_size"])
    g = generator(device, seed, f"step{i}")
    batch = _train_common(g, B, traffic, cfg, device)
    mask = _mask(g, B, side, device)
    rays = camera_rays(side, device).expand(B, side * side, 8)
    batch["mv_rays"] = torch.cat(
        [rays, torch.ones(B, side * side, 3, device=device),
         mask.reshape(B, -1, 1)], -1).contiguous()
    batch["gt_hr_img"] = torch.rand(B, out_side, out_side, 3, generator=g,
                                    device=device)
    batch["gt_lr_mask"] = mask[..., None]
    return batch


def patch_centres(g: torch.Generator, mask: torch.Tensor,
                  p: int) -> torch.Tensor:
    """[B, 2] (y, x) centres of one ``p``^2 patch an item, drawn as the
    stage-1 loader draws them (``data/dataset.py:_sample_patch``, p = 1):
    uniform over the mask's pixels at least ``p // 2`` from the border."""
    B, H, W = mask.shape
    valid = torch.zeros_like(mask)
    h = p // 2
    valid[:, h:H - h, h:W - h] = mask[:, h:H - h, h:W - h]
    flat = torch.multinomial(valid.reshape(B, -1), 1, generator=g)[:, 0]
    return torch.stack([flat // W, flat % W], -1)


def stage1_batch(seed: int, i: int, traffic: Dict, cfg: Dict,
                 device) -> Inputs:
    """Step ``i``'s batch of ``batch`` items, each one ``patch``^2 patch of a
    full-size view (``patch_rgb``): rays with a white background and the
    mask, and the target colours ``gt_color``. Each item has its own head
    mask, and its patch is centred on a pixel of it (``patch_centres``),
    new every step; the patch's pixels are in the loader's order (x in the
    outer loop, y in the inner)."""
    c = cfg["config"]
    B, p = traffic["batch"], traffic["patch"]
    side = int(c["models"]["StyleUnet"]["out_size"]
               * c["dataset"]["down_sample"])
    g = generator(device, seed, f"step{i}")
    batch = _train_common(g, B, traffic, cfg, device)
    rays = camera_rays(side, device).reshape(side, side, 8)
    mask = _mask(g, B, side, device)
    centre = patch_centres(g, mask, p)
    off = torch.arange(p, device=device) - p // 2
    ys = (centre[:, 0, None, None] + off[None, None, :]).expand(B, p, p)
    xs = (centre[:, 1, None, None] + off[None, :, None]).expand(B, p, p)
    items = torch.arange(B, device=device)[:, None, None].expand(B, p, p)
    r = rays[ys, xs].reshape(B, p * p, 8)
    m = mask[items, ys, xs].reshape(B, p * p, 1)
    batch["mv_rays"] = torch.cat(
        [r, torch.ones(B, p * p, 3, device=device), m], -1).contiguous()
    batch["gt_color"] = torch.rand(B, p * p, 3, generator=g, device=device)
    return batch
