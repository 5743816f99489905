"""Multi-GPU serving: the reenactment frame split over the ranks.

Port of ``havatar_tpu/infer/serving.py``. The frame splits as there:

* ``make_sharded_frame_fn`` splits the RAY axis (latency: one frame on N
  GPUs). Every rank generates the planes; each marches its R / N rays with
  the single-GPU code (``renderer.render_rays``, the fused march kernels
  ``march_coarse`` / ``march_fine`` on CUDA); the rgb + feature rows are
  all-gathered (the only collective, [B, 128^2, 3 + 64]); every rank then
  runs the super-resolution on the whole feature image.
* ``make_frame_parallel_fn`` splits the FRAME axis (throughput): each rank
  runs the whole frame on its B / N frames, with no collective.

Where JAX's ``shard_map`` takes global arrays placed with a sharding, each
rank here is a process that holds its block: ``place_frame_inputs`` and
``place_batch_inputs`` take this rank's slice of the host inputs. The
weights are the modules' own, the same on every rank.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.distributed.device_mesh import DeviceMesh

from havatar_tpu_torch.infer.reenact import make_reenact_fn, super_resolve
from havatar_tpu_torch.models.generators import StyleUNetSR
from havatar_tpu_torch.models.renderer import AvatarRenderer
from havatar_tpu_torch.ops.rays import tighten_ray_near_far
from havatar_tpu_torch.parallel import comm
from havatar_tpu_torch.parallel.mesh import (
    batch_sharding,
    local_shard,
    ray_sharding,
)


def make_sharded_frame_fn(mesh: DeviceMesh, renderer: AvatarRenderer,
                          sr: StyleUNetSR = None, num_coarse: int = 64,
                          num_fine: int = 16, to_uint8: bool = False,
                          gated: bool = False) -> Callable:
    """The frame with its ray axis split over ``mesh``'s ranks:
    fn(fixed_volume, style, rays, bg, latent, inv_head_T, front, left,
    right), ``make_reenact_fn``'s arguments, with ``rays`` [B, R / N, 8] and
    ``bg`` [B, R / N, 3] this rank's block (``place_frame_inputs``) and the
    rest whole. Returns the whole frame on every rank: 512^2 RGB (uint8
    with ``to_uint8``), or the feature render [B, s, s, 3 + C] when ``sr``
    is None. The R rays must fill the render_size^2 image."""
    group, n = mesh.get_group(), mesh.size()

    def frame_fn(fixed_volume, style, rays, bg, latent, inv_head_T, front,
                 left, right):
        with torch.inference_mode():
            B, r = rays.shape[:2]
            s = renderer.render_size
            if r * n != s * s:
                raise ValueError(f"{n} ranks x {r} rays do not fill the "
                                 f"{s} x {s} render")
            if gated:
                rays = tighten_ray_near_far(rays, renderer.gate_aabb,
                                            inv_head_T)
            out = renderer(rays, bg, latent, inv_head_T, front, left, right,
                           num_coarse=num_coarse, num_fine=num_fine,
                           fixed_volume=fixed_volume)
            rgb = (out["rgb_fine"] if out["rgb_fine"] is not None
                   else out["rgb_coarse"])
            render = comm.all_gather(rgb, 1, group).reshape(B, s, s, -1)
            return super_resolve(sr, style, render, to_uint8)

    return frame_fn


def make_frame_parallel_fn(mesh: DeviceMesh, renderer: AvatarRenderer,
                           sr: StyleUNetSR = None, num_coarse: int = 64,
                           num_fine: int = 16, to_uint8: bool = False,
                           gated: bool = False) -> Callable:
    """The frame with its frame axis split over ``mesh``'s ranks: each rank
    runs the whole single-GPU frame (``make_reenact_fn``) on its B / N
    frames (``place_batch_inputs``) with no collective, and returns them:
    the block of JAX's global output that one device holds. A caller that
    needs all B frames gathers them (``comm.all_gather``)."""
    del mesh    # the split is in the inputs; the frame needs no collective
    return make_reenact_fn(renderer, sr, num_coarse=num_coarse,
                           num_fine=num_fine, gated=gated, to_uint8=to_uint8)


def place_batch_inputs(mesh: DeviceMesh, batched, replicated) -> tuple:
    """This rank's frames of each ``batched`` input (split on axis 0),
    followed by the ``replicated`` ones as they are."""
    spec = batch_sharding(mesh)
    return (tuple(local_shard(x, spec) for x in batched)
            + tuple(replicated))


def place_frame_inputs(mesh: DeviceMesh, rays, bg, *replicated) -> tuple:
    """This rank's rays and background (split on the ray axis), followed
    by the ``replicated`` inputs as they are."""
    spec = ray_sharding(mesh)
    return (local_shard(rays, spec), local_shard(bg, spec)) + replicated
