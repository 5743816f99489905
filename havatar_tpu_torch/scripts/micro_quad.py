"""The quad field kernels at a stage-2 G step's coarse call, against the
PyTorch pieces of the composition they replace.

A G step renders 128^2 rays an item with 64 coarse samples, so the quad op
(``ops/mlp_quad.py``) sees N = 1,048,576 rows a call, on two 128^2 x 64
planes. Seeded inputs of that shape: numpy ``RandomState(0)`` draws the
five dense layers (LeCun-normal), the planes, 16384 rays (an origin in the
box, a direction) with 64 samples each, ray-major as the renderer orders
them, posenc values and the output cotangent. For float32 planes and for
the same planes in bf16 it times, with CUDA events over 10 calls after 2
warm-up calls (the host clock on the CPU),

* ``fwd_ms`` / ``bwd_ms``: ``quad_forward`` / ``quad_backward``, which
  gather the corner texels and splat the plane gradients in the kernel;
* ``gather_ms``: ``gather_rows``, the [N, 8C] corner rows the forward
  kernel read before; ``regather_splat_ms``: that gather again plus
  ``splat_quads`` of an [N, 8C] float32 gradient (``index_add_`` into the
  quad table), what the backward kernel needed around it before (the
  cells and corner weights, ``quad_rows``, are computed on both paths);

and checks the kernels against their twins (``max_abs_err``: the forward's
largest error; the weight gradients of two backward launches must agree
bit for bit). One JSON line::

    python -m havatar_tpu_torch.scripts.micro_quad [--n-rays 16384] \
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

from havatar_tpu_torch.device import resolve_device
from havatar_tpu_torch.ops import mlp as M
from havatar_tpu_torch.ops import mlp_quad as Q

PLANE, SAMPLES = 128, 64
WARMUP, ITERS = 2, 10


def make_inputs(n_rays: int, device: torch.device):
    """(planes [2][128, 128, 64] f32, warped [n, 3], pe [n, 48], g [n, 68],
    the ten dense tensors), n = n_rays * 64."""
    rng = np.random.RandomState(0)
    params = []
    for o, i in ((M.HID, M.FIN), (M.HID, M.HID), (M.CF, M.HID), (1, M.HID),
                 (3, M.CF)):
        params.append(rng.randn(o, i).astype(np.float32) / np.sqrt(i))
        params.append(rng.randn(o).astype(np.float32) * 0.2)
    planes = [rng.randn(PLANE, PLANE, Q.C_PLANE).astype(np.float32)
              for _ in range(2)]
    origin = rng.uniform(-1, 1, (n_rays, 1, 3)).astype(np.float32)
    direc = rng.randn(n_rays, 1, 3).astype(np.float32)
    direc /= np.linalg.norm(direc, axis=-1, keepdims=True)
    t = np.linspace(0.0, 1.0, SAMPLES, dtype=np.float32)[None, :, None]
    warped = np.clip(origin + t * direc, -1, 1).reshape(-1, 3)
    n = warped.shape[0]
    pe = rng.uniform(-1, 1, (n, Q.N_PE)).astype(np.float32)
    g = rng.randn(n, 3 + M.CF + 1).astype(np.float32)

    def dev(a):
        return torch.from_numpy(a).to(device)

    return ([dev(p) for p in planes], dev(warped), dev(pe), dev(g),
            tuple(dev(p) for p in params))


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


def timings(planes, rows, aux, g, params, device) -> Dict[str, float]:
    """The four times above at one call's arguments (``chip_smoke.py`` phase
    11 takes them here at a G step's captured call)."""
    H, W, _ = planes[0].shape
    dq = torch.randn(rows.shape[0], 8 * Q.C_PLANE, device=device)

    def regather_splat():
        Q.gather_rows(*planes, rows)
        Q.splat_quads(dq, rows, H, W)

    return {
        "fwd_ms": _time_ms(lambda: Q.quad_forward(*planes, rows, aux,
                                                  *params), device),
        "bwd_ms": _time_ms(lambda: Q.quad_backward(*planes, rows, aux, g,
                                                   *params), device),
        "gather_ms": _time_ms(lambda: Q.gather_rows(*planes, rows), device),
        "regather_splat_ms": _time_ms(regather_splat, device)}


def measure(planes, warped, pe, g, params, device) -> Dict[str, Any]:
    """The timings and checks above for one pair of planes."""
    H, W, _ = planes[0].shape
    rows, w8 = Q.quad_rows(warped, H, W)
    aux = torch.cat([pe, w8], -1)
    out = Q.quad_forward(*planes, rows, aux, *params)
    err = float((out - Q.field_radiance_quad_plain(*planes, rows, aux,
                                                   *params)).abs().max())
    a = Q.quad_backward(*planes, rows, aux, g, *params)[3]
    b = Q.quad_backward(*planes, rows, aux, g, *params)[3]
    same = all(torch.equal(x, y) for x, y in zip(a, b))
    del out, a, b
    return {**timings(planes, rows, aux, g, params, device),
            "max_abs_err": err, "weight_grads_bit_identical": same}


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--n-rays", type=int, default=16384)
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: CUDA, an error without it)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    planes, warped, pe, g, params = make_inputs(args.n_rays, device)
    res: Dict[str, Any] = {
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else str(device)),
        "n": warped.shape[0],
        "timer": "cuda events" if device.type == "cuda" else "host clock"}
    with torch.inference_mode():
        for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            res[name] = measure([t.to(dtype) for t in planes], warped, pe, g,
                                params, device)
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
