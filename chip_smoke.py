#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``havatar_tpu_torch``).

Run from the root of a checkout, on a machine with one NVIDIA H100, PyTorch
built for CUDA and ``nvcc`` (on PATH or under /usr/local/cuda):

    python3 chip_smoke.py

It drives the port only, never the JAX package, in five phases, and stops
with a non-zero exit at the first failure:

1. device: the card's name and power limit; build the CUDA kernels from
   ``havatar_tpu_torch/csrc`` and print the build time.
2. kernels vs plain twins at the frame's width (16384 rays, 16 coarse and
   16 fine samples, C = 64) on seeded inputs.
3. the production golden scene (``tests/golden/render_production.npz``):
   all 16384 rays, blind 64+16, through the port's fused path; its PSNR
   against the reference render.
4. frames: the full-width flagship (two 256^2 -> 128^2 x 64 plane
   generators, gated 16+16 march, StyleUNetSR 128^2 -> 512^2) serves five
   frames with seeded conditions and head poses; the launch counters show
   both kernels ran once a frame; one frame is rendered again with the
   twins; frames/s and per-stage times from CUDA events; the device's
   busy time and idle share a frame from a torch.profiler trace.
5. one JSON line listing each kernel: launches, error against its twin,
   its time, the twin's time and its bound on this card.

The last line is ``{"ok": true, "device": {...}}``. Comparisons run with
TF32 off for matmuls and cuDNN, so the twins' float32 products are full
float32.
"""

from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# PSNR of havatar_tpu's fused path (bf16, Pallas kernels in interpret mode,
# on the CPU) against the golden render on every 32nd ray. The CUDA kernels
# take bf16 inputs, so this is the like-for-like bar.
# tests/test_torch_frame.py re-measures it.
JAX_GOLDEN_BF16_PSNR_DB = 57.09588474752982

# NVIDIA H100 SXM data sheet: HBM3 bytes/s, dense bf16 tensor-core and
# float32 (outside the tensor cores) operations/s, at the 700 W limit.
HBM_BYTES_S = 3.35e12
BF16_TC_OPS_S = 989e12
F32_OPS_S = 67e12

R_FRAME, S_COARSE, S_FINE, C, N_PE = 16384, 16, 16, 64, 48
SR_OUT = 512
N_FRAMES = 5

# kernel vs twin: the two sum in different orders, which can flip the bf16
# rounding of a hidden activation. Composited maps and weights average such
# flips away (KERNEL_TOL); a raw MLP output stored in the keeps (feat, rgb,
# sigma) moves by up to a few 1e-3, and its bf16 copy by one bf16 ulp,
# 5e-3 below 1 and under 1% above (KEEP_TOL).
KERNEL_TOL = dict(atol=1e-3, rtol=1e-2)
KEEP_TOL = dict(atol=5e-3, rtol=1e-2)
# kernel frame vs a frame through the twins (see phase_frames)
RENDER_ATOL, FRAME_MIN_PSNR_DB = 5e-3, 40.0


def _fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def _check(ok: bool, msg: str) -> None:
    if not ok:
        _fail(msg)


# ---------------------------------------------------------------------------
# measurement helpers
# ---------------------------------------------------------------------------

def _time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _bound_ms(nbytes: int, tc_ops: float, f32_ops: float):
    """Least time on an H100 for the work: the larger of bytes over HBM
    rate and operations over their peak rates."""
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = tc_ops / BF16_TC_OPS_S + f32_ops / F32_OPS_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _mlp_ops(n: int, mp):
    """(tensor-core ops, f32 ops) of the field MLP on n samples, including
    the f32 corner reduction of their 8 quad rows."""
    fin, hid = mp.w0.shape[1], mp.w0.shape[0]
    cf = mp.wr.shape[1]
    c = (fin - N_PE) // 2
    tc = 2.0 * n * (fin * hid + hid * hid + hid * (cf + 1) + cf * 3)
    return tc, 2.0 * n * 8 * c


def coarse_bound(args, outs):
    quads, aux, dists, mp = args
    R, S = dists.shape
    cf = mp.wr.shape[1]
    tc, f32 = _mlp_ops(R * S, mp)
    f32 += R * S * (10 + 2 * (3 + cf))   # alpha, transmittance, weighted sums
    return _bound_ms(_nbytes(quads, aux, dists, *mp, *outs), tc, f32)


def fine_bound(args, outs):
    q_new, aux_new, keeps, d_concat, ranks, mp = args
    R, Sa = d_concat.shape
    cf = mp.wr.shape[1]
    tc, f32 = _mlp_ops(q_new.shape[0] * q_new.shape[1], mp)
    f32 += R * Sa * (10 + 2 * (3 + cf) + 2 * Sa)  # + rank-compare product
    return _bound_ms(_nbytes(q_new, aux_new, keeps, d_concat, ranks, *mp,
                             *outs), tc, f32)


def _max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def compare_coarse(got, want, where: str) -> dict:
    """Kernel vs twin outputs of the coarse pass. The keeps' sigma is
    compared as the (hi, lo) pair's sum, the value the fine pass reads: a
    hi that rounds the other way moves lo by the same step."""
    errs = {}
    for name, g, w in zip(("rgbmap", "weights"), got[:2], want[:2]):
        errs[name] = _max_err(g, w)
        _check(torch.allclose(g, w, **KERNEL_TOL),
               f"{where}: coarse {name} max abs err {errs[name]}")
    cf5 = got[2].shape[-1]
    kg, kw = got[2].float(), want[2].float()
    errs["keeps"] = _max_err(kg[:, :cf5 - 2], kw[:, :cf5 - 2])
    _check(torch.allclose(kg[:, :cf5 - 2], kw[:, :cf5 - 2], **KEEP_TOL),
           f"{where}: coarse keeps max abs err {errs['keeps']}")
    sg, sw = kg[:, -2] + kg[:, -1], kw[:, -2] + kw[:, -1]
    errs["keeps_sigma"] = _max_err(sg, sw)
    _check(torch.allclose(sg, sw, **KEEP_TOL),
           f"{where}: coarse keep sigma max abs err {errs['keeps_sigma']}")
    return errs


def compare_fine(got, want, where: str) -> dict:
    errs = {}
    for name, g, w in zip(("rgbmap", "weights"), got, want):
        errs[name] = _max_err(g, w)
        _check(torch.allclose(g, w, **KERNEL_TOL),
               f"{where}: fine {name} max abs err {errs[name]}")
    return errs


@contextlib.contextmanager
def marches(coarse, fine):
    """Route AvatarRenderer's two march calls through ``coarse``/``fine``
    inside the block (the plain twins, or timed wrappers of the kernels)."""
    from havatar_tpu_torch.models import renderer as R
    saved = R.march_coarse, R.march_fine
    R.march_coarse, R.march_fine = coarse, fine
    try:
        yield
    finally:
        R.march_coarse, R.march_fine = saved


def _psnr(a, b, clamp: bool = False) -> float:
    """PSNR for a peak of 1; ``clamp`` first clips both to [0, 1], as
    tests/test_production_golden.py scores the golden render."""
    a, b = a.float(), b.float()
    if clamp:
        a, b = a.clamp(0, 1), b.clamp(0, 1)
    mse = float(((a - b) ** 2).mean())
    return 10.0 * math.log10(1.0 / max(mse, 1e-20))


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device() -> None:
    from havatar_tpu_torch.ops import cuda_build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    cuda_build.build(["march"])
    print(f"[1 device] built csrc/march.cu in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for line in cuda_build.build_logs.get("march", "").splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())


def _march_params(gen, dev, alpha_bias: float):
    import torch.nn as nn
    from havatar_tpu_torch.ops import march as M
    fin, hid, cf = 2 * C + N_PE, 128, 64
    lins = [nn.Linear(fin, hid), nn.Linear(hid, hid), nn.Linear(hid, cf),
            nn.Linear(hid, 1), nn.Linear(cf, 3)]
    with torch.no_grad():
        for lin in lins:
            lin.weight.copy_(torch.randn(lin.weight.shape, generator=gen)
                             / lin.in_features ** 0.5)
            lin.bias.copy_(torch.randn(lin.bias.shape, generator=gen) * 0.1)
        lins[3].bias.fill_(alpha_bias)
    mp = M.march_params(lins[:2], lins[2], lins[3], lins[4], C, N_PE,
                        torch.bfloat16)
    return M.MarchParams(*(t.to(dev) for t in mp))


def _quad_inputs(gen, dev, R, S):
    quads = torch.randn(R, S, 8 * C, generator=gen).bfloat16()
    w = torch.rand(R, S, 8, generator=gen)
    w = torch.cat([w[..., :4] / w[..., :4].sum(-1, keepdim=True),
                   w[..., 4:] / w[..., 4:].sum(-1, keepdim=True)], -1)
    pe = torch.sin(torch.randn(R, S, N_PE, generator=gen) * 3)
    return quads.to(dev), torch.cat([pe, w], -1).to(dev)


def _merge_ranks(a, b):
    """Comparison-count merge ranks of two ascending lists (the renderer's
    rule: a before an equal b)."""
    pa = torch.arange(a.shape[1]) + (b[:, None, :] < a[:, :, None]).sum(-1)
    pb = torch.arange(b.shape[1]) + (a[:, :, None] <= b[:, None, :]).sum(1)
    return torch.cat([pa, pb], -1).to(torch.int32)


def phase_kernels(dev) -> None:
    from havatar_tpu_torch.ops import march as M
    gen = torch.Generator().manual_seed(0)
    R, S, Sn, Sk = R_FRAME, S_COARSE, S_FINE, S_COARSE // 2
    mp = _march_params(gen, dev, alpha_bias=1.0)
    quads, aux = _quad_inputs(gen, dev, R, S)
    # a per-ray scale on the deltas spreads acc = sum(weights) over (0, 1)
    dists = (torch.rand(R, 1, generator=gen) * 0.3
             * (0.5 + torch.rand(R, S, generator=gen))).to(dev)
    got = M.march_coarse(quads, aux, dists, mp)
    torch.cuda.synchronize()
    want = M.march_coarse_plain(quads, aux, dists, mp)
    acc = want[1].sum(-1)
    print(f"[2 kernels] coarse acc min/mean/max {float(acc.min()):.4f} "
          f"{float(acc.mean()):.4f} {float(acc.max()):.4f}")
    _check(float(acc.min()) < 0.5 < float(acc.max()),
           "phase-2 inputs do not give non-trivial compositing")
    errs = {"march_coarse": compare_coarse(got, want, "phase 2")}

    zk = torch.sort(torch.rand(R, Sk, generator=gen), -1).values
    zn = torch.sort(torch.rand(R, Sn, generator=gen), -1).values
    ranks = _merge_ranks(zk, zn).to(dev)
    d_concat = (torch.rand(R, 1, generator=gen) * 0.3
                * (0.5 + torch.rand(R, Sk + Sn, generator=gen))).to(dev)
    q_new, aux_new = _quad_inputs(gen, dev, R, Sn)
    args = (q_new, aux_new, want[2], d_concat, ranks, mp, Sk)
    got_f = M.march_fine(*args)
    torch.cuda.synchronize()
    want_f = M.march_fine_plain(*args)
    acc = want_f[1].sum(-1)
    print(f"[2 kernels] fine acc min/mean/max {float(acc.min()):.4f} "
          f"{float(acc.mean()):.4f} {float(acc.max()):.4f}")
    errs["march_fine"] = compare_fine(got_f, want_f, "phase 2")
    for k, e in errs.items():
        print(f"[2 kernels] {k} vs twin max abs err "
              + " ".join(f"{n}={v:.3g}" for n, v in e.items()), flush=True)


def phase_golden(dev) -> None:
    from havatar_tpu_torch.checkpoints.convert import from_jax_params
    from havatar_tpu_torch.models.renderer import AvatarRenderer
    from havatar_tpu_torch.models.skinning import fix_canonical_volume
    g = np.load(ROOT / "tests" / "golden" / "render_production.npz")
    r = AvatarRenderer(compute_dtype=torch.bfloat16)
    missing, unexpected = r.load_state_dict(from_jax_params(
        {k: g[k] for k in g.files if k.startswith(("field.", "skin."))}),
        strict=False)
    # the golden holds computed planes instead of the plane generators
    _check(not unexpected and all(k.startswith(("model_coarse.XY_gen.",
                                                "model_coarse.YZ_gen."))
                                  for k in missing),
           f"golden weights do not fit: {unexpected} {missing[:4]}")
    r = r.to(dev).eval()

    def t(k):
        return torch.from_numpy(np.asarray(g[k], np.float32)).to(dev)

    want = t("render").reshape(1, -1, g["render"].shape[-1])
    with torch.inference_mode():
        vol = fix_canonical_volume(r.skin_volume())
        out = r.render_rays(t("planes").bfloat16(), t("rays"), t("bg"),
                            t("inv_head_T"), num_coarse=int(g["num_coarse"]),
                            num_fine=int(g["num_fine"]), fixed_volume=vol)
    got = out["rgb_fine"]
    torch.cuda.synchronize()
    _check(got.shape == want.shape and bool(torch.isfinite(got).all()),
           f"golden render shape {tuple(got.shape)} or non-finite")
    psnr = _psnr(got[..., :3], want[..., :3], clamp=True)
    print(f"[3 golden] {got.shape[1]} rays, blind 64+16, bf16 kernels: "
          f"PSNR {psnr:.3f} dB vs reference (bar: havatar_tpu bf16 fused "
          f"path {JAX_GOLDEN_BF16_PSNR_DB:.3f} dB - 1), max abs err "
          f"{_max_err(got, want):.4g}", flush=True)
    _check(psnr >= JAX_GOLDEN_BF16_PSNR_DB - 1.0,
           f"golden PSNR {psnr:.3f} dB")


def _frame_inputs(base: dict, i: int) -> dict:
    """Frame ``i``'s inputs: seeded conditions, latent and head pose."""
    rng = np.random.RandomState(1000 + i)
    dev = base["rays"].device
    yaw, pitch = rng.uniform(-0.35, 0.35), rng.uniform(-0.15, 0.15)
    cy, sy, cp, sp = np.cos(yaw), np.sin(yaw), np.cos(pitch), np.sin(pitch)
    rot = (np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
           @ np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]]))
    inv_T = np.concatenate([rot, rng.uniform(-0.05, 0.05, (1, 3))], 0)
    cond = base["front"].shape

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    return {**base, "inv_head_T": t(inv_T[None]),
            "latent": t(rng.randn(1, 32) * 0.5),
            **{k: t(rng.rand(*cond)) for k in ("front", "left", "right")}}


def phase_frames(dev):
    from havatar_tpu_torch.infer.reenact import build_flagship
    from havatar_tpu_torch.ops import march as M

    t0 = time.perf_counter()
    fs = build_flagship(device=dev, seed=0)
    torch.cuda.synchronize()
    print(f"[4 frames] flagship built in {time.perf_counter() - t0:.1f} s "
          f"(gated {S_COARSE}+{S_FINE}, bf16)", flush=True)
    inputs = [_frame_inputs(fs.inputs, i) for i in range(N_FRAMES)]
    renders = []
    full_image = fs.renderer.render_full_image

    def keep_render(*a, **kw):
        out = full_image(*a, **kw)
        renders.append(out)
        return out

    fs.renderer.render_full_image = keep_render   # sees frame_fn's render

    # the main path: N_FRAMES requests through the frame function
    M.march_coarse.launches = M.march_fine.launches = 0
    frames = []
    for i, x in enumerate(inputs):
        frames.append(fs.frame_fn(**x))
        _check(M.march_coarse.launches == i + 1
               and M.march_fine.launches == i + 1,
               f"frame {i}: launch counters {M.march_coarse.launches}, "
               f"{M.march_fine.launches}")
    torch.cuda.synchronize()
    launches = {"march_coarse": M.march_coarse.launches,
                "march_fine": M.march_fine.launches}
    print(f"[4 frames] served {N_FRAMES} frames; launches {launches}",
          flush=True)

    for i, (img, (render, mask)) in enumerate(zip(frames, renders)):
        _check(tuple(img.shape) == (1, SR_OUT, SR_OUT, 3),
               f"frame {i} shape {tuple(img.shape)}")
        _check(bool(torch.isfinite(img).all())
               and bool(torch.isfinite(render).all()),
               f"frame {i} is not finite")
        rgb = render[..., :3].float()
        # sigmoid colours and weights over a white background; 1e-4 for
        # f32 rounding of acc = sum(w) against the weighted sums
        _check(float(rgb.min()) >= -1e-4 and float(rgb.max()) <= 1 + 1e-4
               and float(mask.min()) >= -1e-4
               and float(mask.max()) <= 1 + 1e-4,
               f"frame {i}: render rgb/acc outside [0, 1]")
        print(f"  frame {i}: sr range [{float(img.min()):.3f}, "
              f"{float(img.max()):.3f}], render rgb in [{float(rgb.min()):.3f},"
              f" {float(rgb.max()):.3f}], acc mean {float(mask.mean()):.3f}")

    # frame 0 again, (a) with both twins, (b) with the coarse kernel and the
    # fine twin. The coarse weights place the fine samples through the
    # inverse CDF, which turns a 1e-4 weight difference into a large move of
    # a sample in near-empty space, and that sample's neighbour's delta
    # changes with it: at a few pixels (a) differs by more than the flips of
    # one kernel. So (a) is held by PSNR, and the 5e-3 bound holds (b),
    # where the fine samples are the main path's; phase 5 holds the coarse
    # kernel to its twin on this frame's own inputs.
    captured = {}

    def plain_coarse(*a, **kw):
        captured["march_coarse"] = (a, kw)
        return M.march_coarse_plain(*a, **kw)

    def plain_fine(*a, **kw):
        captured["march_fine"] = (a, kw)
        return M.march_fine_plain(*a, **kw)

    render_kernel, mask_kernel = renders[0]
    renders.clear()
    with marches(plain_coarse, plain_fine):
        img_plain = fs.frame_fn(**inputs[0])
    with marches(M.march_coarse, M.march_fine_plain):
        img_mixed = fs.frame_fn(**inputs[0])
    del fs.renderer.render_full_image      # the class's method again
    (render_plain, _), (render_mixed, _) = renders
    for what, render, img in (("twins", render_plain, img_plain),
                              ("coarse kernel + fine twin", render_mixed,
                               img_mixed)):
        diff = (render_kernel.float() - render.float()).abs()
        pix = int(diff.amax(-1).argmax())
        print(f"[4 frames] frame 0, kernels vs {what}: 128^2 render "
              f"(rgb+feat) max abs err {float(diff.max()):.3g} "
              f"({int((diff > RENDER_ATOL).sum())} of {diff.numel()} beyond "
              f"{RENDER_ATOL}; worst at a pixel with acc "
              f"{float(mask_kernel.flatten()[pix]):.3f}), render rgb PSNR "
              f"{_psnr(render_kernel[..., :3], render[..., :3]):.2f} dB, "
              f"512^2 frame PSNR {_psnr(frames[0], img):.2f} dB", flush=True)
        _check(_psnr(render_kernel[..., :3], render[..., :3])
               >= FRAME_MIN_PSNR_DB, f"{what}: render rgb PSNR")
        _check(_psnr(frames[0], img) >= FRAME_MIN_PSNR_DB,
               f"{what}: frame PSNR")
    _check(_max_err(render_kernel, render_mixed) <= RENDER_ATOL,
           "coarse kernel + fine twin: render max abs err "
           f"{_max_err(render_kernel, render_mixed)}")
    return fs, inputs, launches, captured


def phase_timing(fs, inputs) -> None:
    """Frames/s over back-to-back frames, and per-stage device times from
    CUDA events: plane generators, the two march kernels, the SR net; the
    rest of the frame (gating, skinning, plane gathers, fine sampling and
    merge ranks) is what remains of the frame's span. Returns the host
    clock's ms a frame."""
    from havatar_tpu_torch.ops import march as M
    x = inputs[0]
    for _ in range(2):
        fs.frame_fn(**x)
    torch.cuda.synchronize()
    n = 10
    t0 = time.perf_counter()
    for i in range(n):
        fs.frame_fn(**inputs[i % len(inputs)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    print(f"[4 frames] {n / wall:.2f} frames/s ({wall / n * 1e3:.2f} ms a "
          f"frame, {n} frames back to back after 2 warm-up)", flush=True)

    spans = {k: [] for k in ("frame", "planes", "coarse", "fine", "sr")}
    open_ = {}

    def event():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def begin(name):
        open_[name] = event()

    def end(name):
        spans[name].append((open_.pop(name), event()))

    def timed(fn, name):
        def run(*a, **kw):
            begin(name)
            out = fn(*a, **kw)
            end(name)
            return out
        return run

    field, gen = fs.renderer.model_coarse, fs.generator
    hooks = [field.XY_gen.register_forward_pre_hook(lambda *_: begin("planes")),
             field.YZ_gen.register_forward_hook(lambda *_: end("planes")),
             gen.register_forward_pre_hook(lambda *_: begin("sr")),
             gen.register_forward_hook(lambda *_: end("sr"))]
    try:
        with marches(timed(M.march_coarse, "coarse"),
                     timed(M.march_fine, "fine")):
            for i in range(N_FRAMES):
                begin("frame")
                fs.frame_fn(**inputs[i])
                end("frame")
        torch.cuda.synchronize()
    finally:
        for h in hooks:
            h.remove()
    ms = {k: sum(a.elapsed_time(b) for a, b in v) / len(v)
          for k, v in spans.items()}
    ms["skin_gather_sampling"] = ms["frame"] - (
        ms["planes"] + ms["coarse"] + ms["fine"] + ms["sr"])
    print("[4 frames] per-stage ms (CUDA events, mean of "
          f"{N_FRAMES} frames): " + json.dumps(
              {k: round(v, 4) for k, v in ms.items()}), flush=True)
    return wall / n * 1e3


def phase_profile(fs, inputs, frame_ms: float) -> None:
    """Device busy time a frame: the summed device time of every kernel,
    copy and fill in a torch.profiler trace of N_FRAMES frames, against the
    host clock's unprofiled frame time (the rest is the device's idle
    share), and the kernels that take the most of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(N_FRAMES):
            fs.frame_fn(**inputs[i])
        torch.cuda.synchronize()
    on_dev = sorted((e for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA),
                    key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in on_dev) / 1e3 / N_FRAMES
    if not busy_ms:
        print("[4 frames] device busy time: not measured (the profiler "
              "recorded no device activity)", flush=True)
        return
    print(f"[4 frames] device busy {busy_ms:.4f} ms a frame of "
          f"{frame_ms:.4f} ms on the host clock: idle share "
          f"{1 - busy_ms / frame_ms:.4f} (torch.profiler, {N_FRAMES} "
          f"frames); device launches a frame "
          f"{sum(e.count for e in on_dev) / N_FRAMES:.1f}", flush=True)
    for e in on_dev[:12]:
        print(f"  {e.self_device_time_total / 1e3 / N_FRAMES:8.4f} ms "
              f"{e.count / N_FRAMES:6.1f}x  {e.key[:100]}")


def phase_kernel_line(captured, launches) -> list:
    """Each kernel on the inputs the frame gave it: error against its twin,
    its time and the twin's (CUDA events), and its bound."""
    from havatar_tpu_torch.ops import march as M
    rows = []
    for name, kernel, plain, compare, replaces in (
            ("march_coarse", M.march_coarse, M.march_coarse_plain,
             compare_coarse, "havatar_tpu/ops/pallas_march.py:236"),
            ("march_fine", M.march_fine, M.march_fine_plain, compare_fine,
             "havatar_tpu/ops/pallas_march.py:403")):
        a, kw = captured[name]
        with torch.inference_mode():
            got = kernel(*a, **kw)
            torch.cuda.synchronize()
            errs = compare(got, plain(*a, **kw), "phase 5")
            ms = _time_ms(lambda: kernel(*a, **kw))
            plain_ms = _time_ms(lambda: plain(*a, **kw), iters=5)
        if name == "march_coarse":
            bound, by = coarse_bound(a, got)
        else:
            bound, by = fine_bound(a, got)
        rows.append({
            "name": name, "route": "cuda",
            "source": "havatar_tpu_torch/csrc/march.cu", "replaces": replaces,
            "launches": launches[name],
            "launches_per_frame": launches[name] / N_FRAMES,
            "max_abs_err": max(v for k, v in errs.items() if k != "keeps"),
            "keeps_max_abs_err": errs.get("keeps"),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": by, "library_ms": None})
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    if not (ROOT / "havatar_tpu_torch").is_dir():
        print(f"chip_smoke: no havatar_tpu_torch package beside {__file__}; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    phase_device()
    phase_kernels(dev)
    phase_golden(dev)
    fs, inputs, launches, captured = phase_frames(dev)
    phase_profile(fs, inputs, phase_timing(fs, inputs))
    rows = phase_kernel_line(captured, launches)
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.1f} s",
          flush=True)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
