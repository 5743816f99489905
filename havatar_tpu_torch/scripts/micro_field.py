"""Fused field kernel against the unfused field tail, at the golden scene's
point count.

The port's counterpart of ``scripts/micro_pallas.py``, with its recipe:
numpy ``RandomState(0)`` draws the five dense layers (scale 0.05, in the
JAX script's order), then the points [N, 3] and the plane features
[N, 128], which become bf16. N = 1,310,720 by default: 16384 rays x (64 +
16) samples, the production golden scene's blind schedule. It times

* the unfused path: posenc and five ``F.linear`` calls in bf16 with bf16
  biases (the JAX script's ``xla_path``, the field's own bf16 forward), and
* the fused op ``ops/field.py:fused_field_eval`` (on the GPU the CUDA kernel
  ``field_eval_bf16``),

each over 10 calls after 2 warm-up calls, with CUDA events (the host clock
on the CPU), and prints one JSON line::

    python -m havatar_tpu_torch.scripts.micro_field [--n 1310720] \
        [--device cpu]

It runs on the CUDA device unless ``--device cpu`` is given; there the fused
op is its plain twin.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from havatar_tpu_torch.checkpoints.convert import dense_params_from_jax
from havatar_tpu_torch.device import resolve_device
from havatar_tpu_torch.ops.embedding import positional_encoding
from havatar_tpu_torch.ops.field import NUM_FREQS, fused_field_eval

F_IN, HID = 128, 128
WARMUP, ITERS = 2, 10


def unfused_field_eval(pts: torch.Tensor, pts_feat: torch.Tensor,
                       *params: torch.Tensor,
                       num_freqs: int = NUM_FREQS) -> torch.Tensor:
    """The field's tail without the fused op: posenc, the concat and five
    ``F.linear`` calls in pts_feat's type, biases in that type too ->
    [N, 3 + cf + 1] float32."""
    w0, b0, w1, b1, wf, bf, wa, ba, wr, br = params
    cdt = pts_feat.dtype

    def dense(h, w, b):
        return F.linear(h, w.to(cdt), b.to(cdt))

    x = torch.cat([pts_feat, positional_encoding(pts, num_freqs).to(cdt)], -1)
    h = torch.relu(dense(torch.relu(dense(x, w0, b0)), w1, b1))
    feat = dense(h, wf, bf)
    return torch.cat([dense(feat, wr, br), feat, dense(h, wa, ba)],
                     -1).float()


def make_inputs(n: int, device: torch.device):
    """(pts [n, 3] float32, feat [n, 128] bf16, the ten dense tensors), from
    the JAX script's seed and draw order."""
    rng = np.random.RandomState(0)

    def dense(i, o):
        return {"kernel": rng.randn(i, o).astype(np.float32) * .05,
                "bias": rng.randn(o).astype(np.float32) * .05}

    layers = {"layer0": dense(F_IN + 6 * NUM_FREQS, HID),
              "layer1": dense(HID, HID), "fc_alpha": dense(HID, 1),
              "fc_rgbFeat": dense(HID, 64), "fc_rgb": dense(64, 3)}
    pts = torch.from_numpy(rng.randn(n, 3).astype(np.float32))
    feat = torch.from_numpy(rng.randn(n, F_IN).astype(np.float32))
    return (pts.to(device), feat.to(device).to(torch.bfloat16),
            tuple(t.to(device) for t in dense_params_from_jax(layers)))


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


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--n", type=int, default=1_310_720)
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: CUDA, an error without it)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    pts, feat16, params = make_inputs(args.n, device)
    with torch.inference_mode():
        res = {
            "device": (torch.cuda.get_device_name(device)
                       if device.type == "cuda" else str(device)),
            "n": args.n,
            "timer": ("cuda events" if device.type == "cuda"
                      else "host clock"),
            "unfused_bf16_ms": _time_ms(
                lambda: unfused_field_eval(pts, feat16, *params), device),
            "fused_bf16_ms": _time_ms(
                lambda: fused_field_eval(pts, feat16, *params), device),
            "fused_calls": WARMUP + ITERS}
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
