"""Camera rays and occupancy gating of each ray's [near, far].

Port of ``havatar_tpu/ops/rays.py``: ``intrinsics_to_K``, ``get_rays_np``
and ``make_ray_importance_sampling_map`` (host-side numpy, the same code),
``get_rays``, ``ray_aabb_near_far``, ``head_world_aabb``,
``tighten_ray_near_far``, ``perspective_project`` and
``project_multiview`` on torch tensors.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def intrinsics_to_K(intr, W: int, H: int) -> np.ndarray:
    """(fx, fy, cx_frac, cy_frac) -> 3x3 K."""
    K = np.eye(3, dtype=np.float32)
    K[0, 0], K[1, 1] = intr[0], intr[1]
    K[0, 2], K[1, 2] = intr[2] * W, intr[3] * H
    return K


def get_rays_np(H: int, W: int, intr, c2w: np.ndarray,
                normalize: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """Per-pixel ray origins/directions in world space.

    intr: (fx, fy, cx/W, cy/H) normalized intrinsics; c2w: [3, 4] or [4, 4].
    Returns (rays_o [H, W, 3], rays_d [H, W, 3]) float32.
    """
    fx, fy = float(intr[0]), float(intr[1])
    cx, cy = float(intr[2]) * W, float(intr[3]) * H
    c2w = np.asarray(c2w, dtype=np.float32)
    i, j = np.meshgrid(
        np.arange(W, dtype=np.float32), np.arange(H, dtype=np.float32),
        indexing="xy",
    )
    # analytic K^-1 for a pinhole K (exact; no f32 matrix inversion noise)
    dirs = np.stack([(i - cx) / fx, (j - cy) / fy, np.ones_like(i)], axis=-1)
    rays_d = dirs @ c2w[:3, :3].T
    if normalize:
        rays_d = rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True)
    rays_o = np.broadcast_to(c2w[:3, -1], rays_d.shape).copy()
    return rays_o.astype(np.float32), rays_d.astype(np.float32)


def get_rays(H: int, W: int, intr, c2w: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``get_rays_np`` on a float32 tensor ``c2w`` (normalised directions),
    on its device: (rays_o [H, W, 3], rays_d [H, W, 3])."""
    fx, fy, cx, cy = intr[0], intr[1], intr[2] * W, intr[3] * H
    c2w = torch.as_tensor(c2w, dtype=torch.float32)
    j, i = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=c2w.device),
        torch.arange(W, dtype=torch.float32, device=c2w.device),
        indexing="ij")
    dirs = torch.stack([(i - cx) / fx, (j - cy) / fy, torch.ones_like(i)],
                       dim=-1)
    rays_d = dirs @ c2w[:3, :3].T
    rays_d = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    return c2w[:3, -1].expand(rays_d.shape), rays_d


def make_ray_importance_sampling_map(mask: np.ndarray,
                                     p: float = 0.9) -> np.ndarray:
    """Probability map over pixels with mass ``p`` on mask > 0."""
    probs = np.full(mask.shape, 1.0 - p, dtype=np.float32)
    probs[mask > 0] = p
    return probs / probs.sum()


def ray_aabb_near_far(rays_o: torch.Tensor, rays_d: torch.Tensor,
                      box_min: torch.Tensor, box_max: torch.Tensor,
                      near: torch.Tensor, far: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Slab-method ray/AABB intersection clamped to [near, far].

    rays_o, rays_d: [..., 3]; box_min/box_max broadcastable to them;
    near/far: [..., 1]. Rays that miss the box get [near, near] (every
    sample dist 0, so the march composites pure background).
    """
    inv = 1.0 / rays_d                      # +-inf where d == 0
    t0 = (box_min - rays_o) * inv
    t1 = (box_max - rays_o) * inv
    lo = torch.minimum(t0, t1)
    hi = torch.maximum(t0, t1)
    # d == 0: the ray is parallel to that slab. Inside it the axis never
    # constrains t; outside it the ray never hits. The inf arithmetic above
    # gives NaN when the origin lies ON a slab face; where() replaces it.
    zero = rays_d == 0
    inside = (rays_o >= box_min) & (rays_o <= box_max)
    inf = torch.full_like(lo, float("inf"))
    lo = torch.where(zero, torch.where(inside, -inf, inf), lo)
    hi = torch.where(zero, torch.where(inside, inf, -inf), hi)
    t_enter = torch.maximum(lo.amax(dim=-1, keepdim=True), near)
    t_exit = torch.minimum(hi.amin(dim=-1, keepdim=True), far)
    hit = t_exit > t_enter
    return torch.where(hit, t_enter, near), torch.where(hit, t_exit, near)


def head_world_aabb(xyz_bounding, inv_head_T: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """World AABB of the canonical field box under both skinning transforms
    (identity and the inverse of ``inv_head_T``).

    inv_head_T: [B, 4, 3], rows 0-2 a right-multiplied rotation M, row 3 a
    translation t: canonical = (world + t) @ M. Returns (box_min, box_max),
    each [B, 3].
    """
    b = torch.as_tensor(xyz_bounding, dtype=torch.float32,
                        device=inv_head_T.device)             # [3, 2]
    corners = torch.stack(torch.meshgrid(b[0], b[1], b[2], indexing="ij"),
                          dim=-1).reshape(8, 3)
    M = inv_head_T[:, :3, :]
    t = inv_head_T[:, 3:4, :]
    # world = canonical @ M^-1 - t
    back = torch.einsum("kj,bji->bki", corners, torch.linalg.inv(M)) - t
    allc = torch.cat([corners.expand_as(back), back], dim=1)   # [B, 16, 3]
    return allc.amin(dim=1), allc.amax(dim=1)


def tighten_ray_near_far(ray_batch: torch.Tensor, xyz_bounding,
                         inv_head_T: torch.Tensor) -> torch.Tensor:
    """Rewrite a [B, R, 8+] ray batch's near/far (channels 6:8) to each ray's
    intersection with the avatar's world AABB (``head_world_aabb``)."""
    box_min, box_max = head_world_aabb(xyz_bounding, inv_head_T)
    near, far = ray_aabb_near_far(
        ray_batch[..., 0:3], ray_batch[..., 3:6],
        box_min[:, None, :], box_max[:, None, :],
        ray_batch[..., 6:7], ray_batch[..., 7:8])
    return torch.cat([ray_batch[..., :6], near, far, ray_batch[..., 8:]],
                     dim=-1)


def perspective_project(pts: torch.Tensor, extr: torch.Tensor,
                        K: torch.Tensor, normalize: bool = False,
                        width: int = 0, height: int = 0) -> torch.Tensor:
    """[..., N, 3] world points through [..., 4, 4] extrinsics and
    [..., 3, 3] K -> [..., N, 3] (pixel x, y, depth): cam = pts R^T + t,
    x and y divided by depth; with ``normalize`` they map to [-1, 1] by the
    align_corners convention (x / (W - 1) * 2 - 1)."""
    cam = pts @ extr[..., :3, :3].transpose(-1, -2) + extr[..., None, :3, 3]
    proj = cam @ K.transpose(-1, -2)
    xy = proj[..., :2] / proj[..., 2:3]
    if normalize:
        scale = torch.tensor([2.0 / (width - 1), 2.0 / (height - 1)],
                             dtype=xy.dtype, device=xy.device)
        xy = xy * scale - 1.0
    return torch.cat([xy, proj[..., 2:3]], dim=-1)


def project_multiview(pts: torch.Tensor, extrs: torch.Tensor,
                      intrs: torch.Tensor, img_w: int,
                      img_h: int) -> torch.Tensor:
    """[B, N, 3] points, [B, V, 4, 4] extrinsics, [B, V, 3, 3] K ->
    [B, V, N, 3] normalised projections of each item's points in each of
    its views."""
    return perspective_project(pts[:, None], extrs, intrs, normalize=True,
                               width=img_w, height=img_h)
