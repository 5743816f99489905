"""The quad march kernels at the frame's shapes, beside the PyTorch pieces
of the input stage that feeds them.

The flagship frame marches R = 16384 rays (128^2) over two 128^2 x 64 bf16
planes, gated 16 coarse + 16 fine samples; served blind it is 64 + 16.
Seeded inputs of those shapes: numpy ``RandomState(0)`` draws the five
dense layers (LeCun-normal, fc_alpha's bias 1 so that the compositing is
not trivial), the planes, the rays (an origin in the sampling cube, a
direction) with their samples, already box-warped and a little past the
cube on some rays (the zero padding's work), the deltas and, for the fine
pass, sorted depths whose merge ranks order keeps ++ new samples. For each
schedule it times, with CUDA events over 20 calls after 3 warm-up calls
(the host clock on the CPU),

* ``coarse_ms`` / ``fine_ms``: ``march_coarse`` / ``march_fine`` alone;
* ``posenc_ms``: the positional encoding of the coarse pass's points;
* ``cells_ms``: ``mlp_quad.quad_rows`` (the cells and corner weights) with
  the posenc appended: the kernels' input stage;
* ``stage_coarse_ms`` / ``stage_fine_ms``: the input stage and the kernel,
  one after the other;
* ``field_inputs_quad_ms``: the corner rows [R, S, 8C] as
  ``grid_sample_2d_quad`` gathers them from both planes, with the corner
  weights and the posenc (``nerf_field.field_inputs_quad``): the input
  stage of JAX's quad kernels, which read corner rows;
* ``x_coarse_ms`` / ``x_fine_ms``: ``march_coarse_x`` / ``march_fine_x``,
  the kernels on the reduced MLP input, on the same points (their input,
  ``grid_sample_2d``'s corner sums ++ posenc in the reference's channel
  order, is made once and not timed);

and holds both kernels against their plain twins (``coarse_max_abs_err``,
``fine_max_abs_err``: the largest error of rgbmap and weights). One JSON
line::

    python -m havatar_tpu_torch.scripts.micro_march [--n-rays 16384] \
        [--device cpu]

It runs on the CUDA device unless ``--device cpu`` is given; there the
kernels are their plain twins.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn as nn

from havatar_tpu_torch.device import resolve_device
from havatar_tpu_torch.ops import march as M
from havatar_tpu_torch.ops.embedding import positional_encoding
from havatar_tpu_torch.ops.grid_sample import (
    grid_sample_2d,
    grid_sample_2d_quad,
)
from havatar_tpu_torch.ops.mlp_quad import quad_rows

PLANE, C, N_FREQ, HID, CF = 128, 64, 8, 128, 64
N_PE = 6 * N_FREQ
SCHEDULES = {"gated": (16, 16), "blind": (64, 16)}
WARMUP, ITERS = 3, 20


def make_params(rng: np.random.RandomState, device):
    """The same five dense layers as (block-order MarchParams for the quad
    kernels, interleaved ones for the reduced-input kernels)."""
    fin = 2 * C + N_PE
    lins = [nn.Linear(fin, HID), nn.Linear(HID, HID), nn.Linear(HID, CF),
            nn.Linear(HID, 1), nn.Linear(CF, 3)]
    with torch.no_grad():
        for lin in lins:
            lin.weight.copy_(torch.from_numpy(
                rng.randn(*lin.weight.shape).astype(np.float32)
                / np.sqrt(lin.in_features)))
            lin.bias.copy_(torch.from_numpy(
                rng.randn(*lin.bias.shape).astype(np.float32) * 0.1))
        lins[3].bias.fill_(1.0)
    return tuple(M.march_params(lins[:2], lins[2], lins[3], lins[4], C, N_PE,
                                torch.bfloat16, permute=p).to(device)
                 for p in (True, False))


def _points(rng, n_rays: int, S: int) -> np.ndarray:
    """[n_rays, S, 3] box-warped sample points along seeded rays; one ray
    in 8 runs 5% past the cube."""
    origin = rng.uniform(-1, 1, (n_rays, 1, 3)).astype(np.float32)
    direc = rng.randn(n_rays, 1, 3).astype(np.float32)
    direc /= np.linalg.norm(direc, axis=-1, keepdims=True)
    t = np.linspace(0.0, 1.0, S, dtype=np.float32)[None, :, None]
    lim = np.where(rng.rand(n_rays, 1, 1) < 0.125, 1.05, 1.0)
    return np.clip(origin + t * direc, -lim, lim).astype(np.float32)


def _deltas(rng, n_rays: int, S: int) -> np.ndarray:
    """Per-ray scaled deltas, spreading acc = sum(weights) over (0, 1)."""
    return (rng.rand(n_rays, 1) * 0.3
            * (0.5 + rng.rand(n_rays, S))).astype(np.float32)


def _merge_ranks(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    pa = np.arange(a.shape[1]) + (b[:, None, :] < a[:, :, None]).sum(-1)
    pb = np.arange(b.shape[1]) + (a[:, :, None] <= b[:, None, :]).sum(1)
    return np.concatenate([pa, pb], -1).astype(np.int32)


def make_inputs(n_rays: int, S: int, Sn: int, device):
    """Seeded planes [1, 128, 128, 64] bf16 (XY, ZY), warped points of the
    coarse and the fine pass, deltas, concat deltas and merge ranks."""
    rng = np.random.RandomState(0)
    mp, mp_x = make_params(rng, device)
    planes = [torch.from_numpy(rng.randn(1, PLANE, PLANE, C).astype(
        np.float32)).to(device).bfloat16() for _ in range(2)]
    Sk = S // 2
    zk = np.sort(rng.rand(n_rays, Sk), -1)
    zn = np.sort(rng.rand(n_rays, Sn), -1)

    def dev(a):
        return torch.from_numpy(a).to(device)

    return {"mp": mp, "mp_x": mp_x, "planes": planes,
            "pts": dev(_points(rng, n_rays, S)),
            "pts_new": dev(_points(rng, n_rays, Sn)),
            "dists": dev(_deltas(rng, n_rays, S)),
            "d_concat": dev(_deltas(rng, n_rays, Sk + Sn)),
            "ranks": dev(_merge_ranks(zk, zn)), "num_keep": Sk}


def posenc(warped: torch.Tensor) -> torch.Tensor:
    return positional_encoding(warped, N_FREQ).float()


def input_stage(planes, warped: torch.Tensor) -> tuple:
    """The kernels' leading arguments: (plane_xy, plane_zy, rows [R, S, 2]
    int32, aux [R, S, n_pe + 8] = posenc ++ the corner weights)."""
    R, S, _ = warped.shape
    rows, w8 = quad_rows(warped.reshape(-1, 3), PLANE, PLANE)
    aux = torch.cat([posenc(warped), w8.reshape(R, S, 8)], -1)
    return (*planes, rows.reshape(R, S, 2), aux)


def corner_rows_stage(planes, warped: torch.Tensor):
    """The input stage of JAX's quad kernels, as ``field_inputs_quad``
    builds it: (corner rows [R, S, 8C], aux = posenc ++ corner weights)."""
    R, S, _ = warped.shape
    w = warped.reshape(1, R * S, 3)
    rows_xy, w_xy = grid_sample_2d_quad(planes[0], w[..., [0, 1]])
    rows_zy, w_zy = grid_sample_2d_quad(planes[1], w[..., [2, 1]])
    aux = torch.cat([posenc(warped), w_xy.reshape(R, S, 4),
                     w_zy.reshape(R, S, 4)], -1)
    return torch.cat([rows_xy, rows_zy], -1).reshape(R, S, -1), aux


def reduced_input(planes, warped: torch.Tensor) -> torch.Tensor:
    """The reduced-input kernels' x [R, S, 2C + n_pe] bf16: both planes'
    bilinear features (``grid_sample_2d``) interleaved as the reference
    orders them (feature 2c + p), then posenc."""
    R, S, _ = warped.shape
    w = warped.reshape(1, R * S, 3)
    feats = torch.stack([grid_sample_2d(planes[0], w[..., [0, 1]]),
                         grid_sample_2d(planes[1], w[..., [2, 1]])], -1)
    return torch.cat([feats.reshape(R, S, 2 * C),
                      posenc(warped).to(feats.dtype)], -1).contiguous()


def _time_ms(fn, device: torch.device) -> float:
    for _ in range(WARMUP):
        fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(ITERS):
            fn()
        return (time.perf_counter() - t0) / ITERS * 1e3
    torch.cuda.synchronize(device)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(ITERS):
        fn()
    e1.record()
    torch.cuda.synchronize(device)
    return e0.elapsed_time(e1) / ITERS


def _err(got, want) -> float:
    return max(float((g.float() - w.float()).abs().max())
               for g, w in zip(got[:2], want[:2]))


def measure(inp: Dict[str, Any], device: torch.device) -> Dict[str, Any]:
    """The timings and checks above for one schedule's inputs."""
    planes, mp, Sk = inp["planes"], inp["mp"], inp["num_keep"]
    pts, pts_new = inp["pts"], inp["pts_new"]
    dists, dc, ranks = inp["dists"], inp["d_concat"], inp["ranks"]
    xs, xs_new = input_stage(planes, pts), input_stage(planes, pts_new)
    got = M.march_coarse(*xs, dists, mp)
    want = M.march_coarse_gather_plain(*xs, dists, mp)
    keeps = want[2]
    fine_args = (*xs_new, keeps, dc, ranks, mp, Sk)
    got_f = M.march_fine(*fine_args)
    want_f = M.march_fine_gather_plain(*fine_args)
    res = {"coarse_max_abs_err": _err(got, want),
           "fine_max_abs_err": _err(got_f, want_f)}
    del got, want, got_f, want_f

    def stage_coarse():
        M.march_coarse(*input_stage(planes, pts), dists, mp)

    def stage_fine():
        M.march_fine(*input_stage(planes, pts_new), keeps, dc, ranks, mp, Sk)

    res.update({
        "coarse_ms": _time_ms(lambda: M.march_coarse(*xs, dists, mp),
                              device),
        "fine_ms": _time_ms(lambda: M.march_fine(*fine_args), device),
        "posenc_ms": _time_ms(lambda: posenc(pts), device),
        "cells_ms": _time_ms(lambda: input_stage(planes, pts), device),
        "stage_coarse_ms": _time_ms(stage_coarse, device),
        "stage_fine_ms": _time_ms(stage_fine, device),
        "field_inputs_quad_ms": _time_ms(
            lambda: corner_rows_stage(planes, pts), device)})
    mp_x = inp["mp_x"]
    x, x_new = reduced_input(planes, pts), reduced_input(planes, pts_new)
    res.update({
        "x_coarse_ms": _time_ms(lambda: M.march_coarse_x(x, dists, mp_x),
                                device),
        "x_fine_ms": _time_ms(lambda: M.march_fine_x(
            x_new, keeps, dc, ranks, mp_x, Sk), device)})
    return res


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--n-rays", type=int, default=16384)
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: CUDA, an error without it)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    res: Dict[str, Any] = {
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else str(device)),
        "n_rays": args.n_rays,
        "timer": "cuda events" if device.type == "cuda" else "host clock"}
    with torch.inference_mode():
        for name, (S, Sn) in SCHEDULES.items():
            inp = make_inputs(args.n_rays, S, Sn, device)
            res[name] = {"samples": [S, Sn], **measure(inp, device)}
            del inp
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
