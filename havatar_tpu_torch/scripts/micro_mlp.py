"""The dense-chain kernels at a stage-1 step's calls, against the unfused
chain.

A stage-1 step (``singleview_512_base.yml``, 2 items of one 64 x 64 patch,
64 + 16 samples) runs the fused chain (``ops/mlp.py``) on N = 524,288 rows
in its coarse call and 131,072 in its fine call. Seeded inputs of those
shapes: numpy ``RandomState(0)`` draws the five dense layers
(LeCun-normal), x [N, 176] and the output cotangent g [N, 68]. For x in
float32 and in bf16 it times, with CUDA events over 10 calls after 2
warm-up calls (the host clock on the CPU),

* ``fwd_ms`` / ``bwd_ms``: ``mlp_forward`` / ``mlp_backward``;
* ``unfused_fwd_ms``: the chain as five ``F.linear`` calls in x's type;
  ``unfused_bwd_ms``: autograd's backward of it to x and every parameter
  (forward and backward timed together, less the forward);

and checks the kernels against their twins (``fwd_max_abs_err``,
``bwd_max_abs_err`` over dx and the ten gradients) and whether two
backward launches give the same parameter gradients bit for bit. One JSON
line::

    python -m havatar_tpu_torch.scripts.micro_mlp [--n 524288 131072] \
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
import torch.nn.functional as F

from havatar_tpu_torch.device import resolve_device
from havatar_tpu_torch.ops import mlp as M

WARMUP, ITERS = 2, 10


def make_inputs(n: int, device: torch.device):
    """(x [n, 176] f32, g [n, 68] f32, the ten dense tensors)."""
    rng = np.random.RandomState(0)
    params = []
    for o, i in ((M.HID, M.FIN), (M.HID, M.HID), (M.CF, M.HID), (1, M.HID),
                 (3, M.CF)):
        params.append(rng.randn(o, i).astype(np.float32) / np.sqrt(i))
        params.append(rng.randn(o).astype(np.float32) * 0.2)
    x = rng.randn(n, M.FIN).astype(np.float32)
    g = rng.randn(n, 3 + M.CF + 1).astype(np.float32)

    def dev(a):
        return torch.from_numpy(a).to(device)

    return dev(x), dev(g), tuple(dev(p) for p in params)


def unfused_chain(x, params, g=None):
    """The chain as the field runs it without the fused op: five
    ``F.linear`` calls in x's type; with ``g`` also autograd's backward to
    x and every parameter."""
    if g is not None:
        with torch.enable_grad():
            x = x.detach().requires_grad_()
            params = [p.detach().requires_grad_() for p in params]
            out = unfused_chain(x, params)
            return torch.autograd.grad(out, (x, *params), g)
    w0, b0, w1, b1, wf, bf, wa, ba, wr, br = params
    cdt = x.dtype

    def dense(h, w, b):
        return F.linear(h, w.to(cdt), b.to(cdt))

    h = torch.relu(dense(torch.relu(dense(x, w0, b0)), w1, b1))
    feat = dense(h, wf, bf)
    return torch.cat([dense(feat, wr, br).float(), feat.float(),
                      dense(h, wa, ba).float()], -1)


def time_ms(fn, device: torch.device, iters: int = ITERS,
            warmup: int = WARMUP) -> float:
    for _ in range(warmup):
        fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters * 1e3
    torch.cuda.synchronize(device)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize(device)
    return e0.elapsed_time(e1) / iters


def timings(x, g, params, device) -> Dict[str, float]:
    """The four times above at one call's arguments (``chip_smoke.py``
    phases 7 and 11 take them here)."""
    t = {"fwd_ms": time_ms(lambda: M.mlp_forward(x, *params), device),
         "bwd_ms": time_ms(lambda: M.mlp_backward(x, g, *params), device),
         "unfused_fwd_ms": time_ms(lambda: unfused_chain(x, params), device,
                                   5, 1)}
    both = time_ms(lambda: unfused_chain(x, params, g), device, 5, 1)
    t["unfused_bwd_ms"] = both - t["unfused_fwd_ms"]
    return t


def measure(x, g, params, device) -> Dict[str, Any]:
    """The timings and checks above for one x."""
    out = M.mlp_forward(x, *params)
    fwd_err = float((out - M.fused_mlp_chain_plain(x, *params)).abs().max())
    dx, a = M.mlp_backward(x, g, *params)
    want_dx, want = M.fused_mlp_chain_bwd_plain(x, g, *params)
    bwd_err = max(float((p.float() - q.float()).abs().max())
                  for p, q in zip((dx, *a), (want_dx, *want)))
    b = M.mlp_backward(x, g, *params)[1]
    same = all(torch.equal(p, q) for p, q in zip(a, b))
    del out, dx, a, b, want_dx, want
    return {**timings(x, g, params, device), "fwd_max_abs_err": fwd_err,
            "bwd_max_abs_err": bwd_err, "grads_bit_identical": same}


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--n", type=int, nargs="+", default=[524288, 131072])
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: CUDA, an error without it)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    res: Dict[str, Any] = {
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else str(device)),
        "timer": "cuda events" if device.type == "cuda" else "host clock"}
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    with torch.no_grad():
        for n in args.n:
            x, g, params = make_inputs(n, device)
            for name, dtype in (("f32", torch.float32),
                                ("bf16", torch.bfloat16)):
                res[f"{name}_{n}"] = measure(x.to(dtype), g, params, device)
            del x, g
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
