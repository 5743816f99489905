#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``havatar_tpu_torch``).

Run from the root of a checkout, on a machine with one NVIDIA H100, PyTorch
built for CUDA and ``nvcc`` (on PATH or under /usr/local/cuda):

    python3 chip_smoke.py

It drives the port only, never the JAX package, in these phases, and stops
with a non-zero exit at the first failure:

1. device: the card's name and power limit; the image and YAML packages the
   port found; build the CUDA kernels from ``havatar_tpu_torch/csrc`` and
   print the build time.
2. the four march kernels vs their plain twins at the frame's width (16384
   rays, 16 coarse and 16 fine samples, C = 64) on seeded inputs; the
   reduced-input pair also against the quad pair on the same points.
3. the production golden scene (``tests/golden/render_production.npz``):
   all 16384 rays, blind 64+16, through the renderer's three
   configurations (fused on corner rows, fused on the reduced input, exact
   float32); each one's PSNR against the reference render.
4. frames: the full-width flagship (two 256^2 -> 128^2 x 64 plane
   generators, gated 16+16 march, StyleUNetSR 128^2 -> 512^2) serves five
   frames with seeded conditions and head poses; the launch counters show
   both quad kernels ran once a frame; one frame is rendered again with the
   twins; frames/s and per-stage times from CUDA events; the device's
   busy time and idle share a frame from a torch.profiler trace.
5. the same five frames through a flagship built on the reduced-input
   kernels: their launch counts, its render against phase 4's with the fine
   samples fixed, its frames against phase 4's, its per-stage times.
6. serve: a seeded stage-2 ``.pt`` checkpoint and a driving split (two
   cameras, eight frames, condition PNGs) are written to a temporary
   directory and served through ``havatar_tpu_torch.cli.reenact.main``:
   fast gated 16+16 (twice: cold, then warm; the frames must be the same),
   fast blind 64+16 and exact. File names, frame shapes,
   launch counts, the ray cache, the first frame against
   ``make_reenact_fn`` on the same tensors, exact against fast, and each
   run's frames/s beside phase 4's bare frame rate.
7. one JSON line listing each kernel: launches, error against its twin,
   its time, the twin's time and its bound on this card.

The last line is ``{"ok": true, "device": {...}}``. Comparisons run with
TF32 off for matmuls and cuDNN, so the twins' float32 products are full
float32.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile
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
# tests/test_production_golden.py:_check, the exact float32 path's bar
GOLDEN_F32_MIN_PSNR_DB, GOLDEN_F32_TOL = 55.0, dict(atol=5e-3, rtol=1e-2)
# served frames: exact float32 against fast bf16 on the same item
SERVE_MIN_PSNR_DB = 35.0
SERVE_FRAMES, SERVE_VIEWS = 8, 2
SERVE_CONFIG = "singleview_512_HD_base.yml"   # built into the port


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


def _mlp_ops(n: int, mp, quad: bool = True):
    """(tensor-core ops, f32 ops) of the field MLP on n samples; with
    ``quad`` including the f32 corner reduction of their 8 quad rows."""
    fin, hid = mp.w0.shape[1], mp.w0.shape[0]
    cf = mp.wr.shape[1]
    c = (fin - N_PE) // 2
    tc = 2.0 * n * (fin * hid + hid * hid + hid * (cf + 1) + cf * 3)
    return tc, 2.0 * n * 8 * c if quad else 0.0


def coarse_bound(args, outs):
    """Bound of either coarse kernel from its own call's arguments:
    (quads, aux, dists, mp) or (x, dists, mp)."""
    *xs, dists, mp = args
    R, S = dists.shape
    cf = mp.wr.shape[1]
    tc, f32 = _mlp_ops(R * S, mp, quad=len(xs) == 2)
    f32 += R * S * (10 + 2 * (3 + cf))   # alpha, transmittance, weighted sums
    return _bound_ms(_nbytes(*xs, dists, *mp.tensors(), *outs), tc, f32)


def fine_bound(args, outs):
    """Bound of either fine kernel: (q_new, aux_new, keeps, d_concat, ranks,
    mp[, num_keep]) or (x_new, keeps, d_concat, ranks, mp[, num_keep])."""
    args = [a for a in args if not isinstance(a, int)]
    *xs, keeps, d_concat, ranks, mp = args
    R, Sa = d_concat.shape
    cf = mp.wr.shape[1]
    tc, f32 = _mlp_ops(xs[0].shape[0] * xs[0].shape[1], mp,
                       quad=len(xs) == 2)
    f32 += R * Sa * (10 + 2 * (3 + cf) + 2 * Sa)  # + rank-compare product
    return _bound_ms(_nbytes(*xs, keeps, d_concat, ranks, *mp.tensors(),
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
def patched(**names):
    """Replace names of ``havatar_tpu_torch.models.renderer`` inside the
    block: its march calls (by the plain twins, or timed wrappers of the
    kernels) or its ``sample_pdf``."""
    from havatar_tpu_torch.models import renderer as R
    saved = {k: getattr(R, k) for k in names}
    for k, v in names.items():
        setattr(R, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(R, k, v)


def marches(coarse, fine):
    return patched(march_coarse=coarse, march_fine=fine)


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
    import cv2
    import yaml
    from havatar_tpu_torch.data import image_io
    print(f"[1 device] image codec {image_io.CODEC} {cv2.__version__}, "
          f"yaml {yaml.__version__}", flush=True)
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
    return tuple(M.march_params(lins[:2], lins[2], lins[3], lins[4], C, N_PE,
                                torch.bfloat16, permute=p).to(dev)
                 for p in (True, False))


def _reduce_interleave(quads, aux):
    """The reduced MLP input of the same points, as ``grid_sample_2d``
    rounds it (f32 corner sums rounded to bf16), un-permuted to the
    reference's interleaved channel order."""
    from havatar_tpu_torch.ops import march as M
    R, S = quads.shape[:2]
    xb = M._build_x(quads.reshape(R * S, -1), aux.reshape(R * S, -1), C, N_PE)
    planes = torch.stack([xb[:, :C], xb[:, C:2 * C]], -1).flatten(-2)
    return torch.cat([planes, xb[:, 2 * C:]], -1).reshape(R, S, -1).contiguous()


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
    mp, mp_x = _march_params(gen, dev, alpha_bias=1.0)
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

    # kernels 3 and 4 on the same points, reduced as grid_sample_2d does
    x, x_new = _reduce_interleave(quads, aux), _reduce_interleave(q_new,
                                                                  aux_new)
    got_x = M.march_coarse_x(x, dists, mp_x)
    torch.cuda.synchronize()
    errs["march_coarse_x"] = compare_coarse(
        got_x, M.march_coarse_x_plain(x, dists, mp_x), "phase 2 (x)")
    args_x = (x_new, want[2], d_concat, ranks, mp_x, Sk)
    got_fx = M.march_fine_x(*args_x)
    torch.cuda.synchronize()
    errs["march_fine_x"] = compare_fine(
        got_fx, M.march_fine_x_plain(*args_x), "phase 2 (x)")
    # against kernels 1 and 2: layer0's summation order only
    errs["march_coarse_x vs march_coarse"] = compare_coarse(
        got_x, got, "phase 2 (x vs quad)")
    errs["march_fine_x vs march_fine"] = compare_fine(
        got_fx, got_f, "phase 2 (x vs quad)")
    for k, e in errs.items():
        print(f"[2 kernels] {k}{'' if ' vs ' in k else ' vs twin'} max abs err "
              + " ".join(f"{n}={v:.3g}" for n, v in e.items()), flush=True)


def phase_golden(dev) -> None:
    """The golden scene through the renderer's three configurations. The
    two fused ones (bf16 kernels) are held to havatar_tpu's bf16 fused path
    less 1 dB; the exact one (float32) to the JAX package's own bar."""
    from havatar_tpu_torch.checkpoints.convert import from_jax_params
    from havatar_tpu_torch.models.renderer import AvatarRenderer
    from havatar_tpu_torch.models.skinning import fix_canonical_volume
    g = np.load(ROOT / "tests" / "golden" / "render_production.npz")
    weights = from_jax_params({k: g[k] for k in g.files
                               if k.startswith(("field.", "skin."))})

    def t(k):
        return torch.from_numpy(np.asarray(g[k], np.float32)).to(dev)

    want = t("render").reshape(1, -1, g["render"].shape[-1])
    for what, kw in (
            ("fused on corner rows, bf16 kernels",
             dict(compute_dtype=torch.bfloat16, use_fused_march=True)),
            ("fused on the reduced input, bf16 kernels",
             dict(compute_dtype=torch.bfloat16, use_fused_march=True,
                  use_quad_march=False)),
            ("exact, float32", dict())):
        r = AvatarRenderer(**kw)
        missing, unexpected = r.load_state_dict(weights, strict=False)
        # the golden holds computed planes instead of the plane generators
        _check(not unexpected and all(k.startswith(("model_coarse.XY_gen.",
                                                    "model_coarse.YZ_gen."))
                                      for k in missing),
               f"golden weights do not fit: {unexpected} {missing[:4]}")
        r = r.to(dev).eval()
        with torch.inference_mode():
            vol = fix_canonical_volume(r.skin_volume())
            out = r.render_rays(t("planes").to(r.compute_dtype), t("rays"),
                                t("bg"), t("inv_head_T"),
                                num_coarse=int(g["num_coarse"]),
                                num_fine=int(g["num_fine"]), fixed_volume=vol)
        got = out["rgb_fine"]
        torch.cuda.synchronize()
        _check(got.shape == want.shape and bool(torch.isfinite(got).all()),
               f"golden render ({what}) shape {tuple(got.shape)} or "
               f"non-finite")
        psnr = _psnr(got[..., :3], want[..., :3], clamp=True)
        fused = kw.get("use_fused_march", False)
        bar = (JAX_GOLDEN_BF16_PSNR_DB - 1.0 if fused
               else GOLDEN_F32_MIN_PSNR_DB)
        print(f"[3 golden] {got.shape[1]} rays, blind 64+16, {what}: "
              f"PSNR {psnr:.3f} dB vs reference (bar {bar:.3f} dB), max abs "
              f"err {_max_err(got, want):.4g}", flush=True)
        _check(psnr >= bar, f"golden PSNR ({what}) {psnr:.3f} dB")
        if not fused:
            _check(torch.allclose(got, want, **GOLDEN_F32_TOL),
                   f"golden render ({what}) beyond {GOLDEN_F32_TOL}")


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
    # where the fine samples are the main path's; phase 7 holds the coarse
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
    return fs, inputs, frames, launches, captured


def phase_frames_reduced(dev, inputs, quad_fs, quad_frames):
    """The same frames through a flagship built on the reduced-input
    kernels (same seed, so the same weights). Its main path is held to
    phase 4's frames by PSNR; frame 0's 128^2 render is held to phase 4's
    configuration to RENDER_ATOL with the fine samples fixed (both take the
    quad configuration's inverse-CDF samples), where the two differ only in
    layer0's summation order."""
    from havatar_tpu_torch.infer.reenact import build_flagship
    from havatar_tpu_torch.models import renderer as R
    from havatar_tpu_torch.ops import march as M

    fs = build_flagship(device=dev, seed=0, use_quad_march=False)
    M.march_coarse_x.launches = M.march_fine_x.launches = 0
    before = M.march_coarse.launches, M.march_fine.launches
    frames = []
    for i, x in enumerate(inputs):
        frames.append(fs.frame_fn(**x))
        _check(M.march_coarse_x.launches == i + 1
               and M.march_fine_x.launches == i + 1,
               f"reduced-input frame {i}: launch counters "
               f"{M.march_coarse_x.launches}, {M.march_fine_x.launches}")
    torch.cuda.synchronize()
    launches = {"march_coarse_x": M.march_coarse_x.launches,
                "march_fine_x": M.march_fine_x.launches}
    _check((M.march_coarse.launches, M.march_fine.launches) == before,
           "the reduced-input configuration launched a quad kernel")
    print(f"[5 reduced] served {len(inputs)} frames on the reduced-input "
          f"kernels; launches {launches}", flush=True)
    for i, (a, b) in enumerate(zip(frames, quad_frames)):
        _check(tuple(a.shape) == (1, SR_OUT, SR_OUT, 3)
               and bool(torch.isfinite(a).all()), f"reduced frame {i}")
        db = _psnr(a, b)
        print(f"  frame {i}: 512^2 frame PSNR vs the quad configuration "
              f"{db:.2f} dB")
        _check(db >= FRAME_MIN_PSNR_DB, f"reduced-input frame {i}: {db} dB")

    # frame 0 with the fine samples fixed to the quad configuration's
    samples, captured = [], {}
    sample_pdf = R.sample_pdf

    def record(*a, **kw):
        samples.append(sample_pdf(*a, **kw))
        return samples[-1]

    def capture(fn, name):
        def run(*a, **kw):
            captured[name] = (a, kw)
            return fn(*a, **kw)
        return run

    def render0(f):
        x = {k: v for k, v in inputs[0].items() if k != "style"}
        from havatar_tpu_torch.ops.rays import tighten_ray_near_far
        with torch.inference_mode():
            rays = tighten_ray_near_far(x.pop("rays"), f.renderer.gate_aabb,
                                        x["inv_head_T"])
            return f.renderer.render_full_image(
                rays, x["bg"], x["latent"], x["inv_head_T"], x["front"],
                x["left"], x["right"], num_coarse=S_COARSE, num_fine=S_FINE,
                fixed_volume=x["fixed_volume"])[0]

    with patched(sample_pdf=record):
        render_quad = render0(quad_fs)
    with patched(sample_pdf=lambda *a, **kw: samples[0],
                 march_coarse_x=capture(M.march_coarse_x, "march_coarse_x"),
                 march_fine_x=capture(M.march_fine_x, "march_fine_x")):
        render_x = render0(fs)
    torch.cuda.synchronize()
    err = _max_err(render_x, render_quad)
    print(f"[5 reduced] frame 0, reduced-input vs quad kernels, fine samples "
          f"fixed: 128^2 render (rgb+feat) max abs err {err:.3g}, rgb PSNR "
          f"{_psnr(render_x[..., :3], render_quad[..., :3]):.2f} dB",
          flush=True)
    _check(err <= RENDER_ATOL, f"reduced-input render max abs err {err}")
    return fs, launches, captured


def phase_timing(fs, inputs, tag: str = "4 frames", suffix: str = ""):
    """Frames/s over back-to-back frames, and per-stage device times from
    CUDA events: plane generators, the two march kernels (``suffix`` "_x"
    for the reduced-input pair), the SR net; the rest of the frame (gating,
    skinning, plane gathers and, for the reduced-input pair, their corner
    reduction, fine sampling and merge ranks) is what remains of the
    frame's span. Returns the host clock's ms a frame."""
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
    print(f"[{tag}] {n / wall:.2f} frames/s ({wall / n * 1e3:.2f} ms a "
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
        with patched(**{
                f"march_coarse{suffix}": timed(
                    getattr(M, f"march_coarse{suffix}"), "coarse"),
                f"march_fine{suffix}": timed(
                    getattr(M, f"march_fine{suffix}"), "fine")}):
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
    print(f"[{tag}] per-stage ms (CUDA events, mean of "
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


def _write_serving_files(root: str, fs) -> tuple:
    """A stage-2 checkpoint of the flagship's seeded modules with seeded
    latent codes, and a driving split in the reference's format: 512^2
    frames, two cameras, SERVE_FRAMES frames with seeded head poses and six
    seeded 256^2 condition PNGs each. Returns (checkpoint, split)."""
    from havatar_tpu_torch.checkpoints.stage2 import stage2_checkpoint
    from havatar_tpu_torch.data.image_io import imwrite_rgb
    rng = np.random.RandomState(7)
    latents = torch.from_numpy(
        (rng.randn(SERVE_FRAMES, 32) * 0.5).astype(np.float32))
    ckpt = os.path.join(root, "latest.pt")
    torch.save(stage2_checkpoint(fs.renderer, fs.generator, latents, 0), ckpt)

    def camera(x, yaw):
        c, s_ = math.cos(yaw), math.sin(yaw)
        c2w = np.eye(4)
        c2w[:3, :3] = (np.array([[c, 0, s_], [0, 1, 0], [-s_, 0, c]])
                       @ np.diag([1.0, -1.0, -1.0]))
        c2w[:3, 3] = [x, -0.1, 3.0]
        ori = np.eye(4)
        ori[:3, 3] = [0.0, 0.0, 3.0]     # distance 3: near 1.4, far 4.0
        return c2w.tolist(), ori.tolist()

    cams = [camera(0.0, 0.0), camera(0.45, 0.15)]
    frames = []
    for f in range(SERVE_FRAMES):
        inst = os.path.join(root, f"inst_{f}")
        os.makedirs(inst)
        for view in ("front", "left", "right"):
            for kind in ("render", "normal"):
                img = rng.randint(1, 256, (256, 256, 3)).astype(np.uint8)
                imwrite_rgb(os.path.join(
                    inst, f"ortho_{view}_{kind}_256_baseGama.png"), img)
        yaw, pitch = rng.uniform(-0.35, 0.35), rng.uniform(-0.15, 0.15)
        cy, sy = math.cos(yaw), math.sin(yaw)
        cp, sp = math.cos(pitch), math.sin(pitch)
        head = np.eye(4)
        head[:3, :3] = (np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
                        @ np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]]))
        head[3, :3] = rng.uniform(-0.05, 0.05, 3)
        frames.append({
            "fidx": f, "head_transformation": head.tolist(),
            "inst_dir": inst,
            "mutiview_info_ls": [
                {"view_name": str(v), "transform_matrix": c2w,
                 "transform_matrix_ori": ori}
                for v, (c2w, ori) in enumerate(cams)]})
    split = os.path.join(root, "sv_v31_all.json")
    with open(split, "w") as f:
        json.dump({"img_res": SR_OUT,
                   "mutiview_intr_ls": [[1.2 * SR_OUT, 1.2 * SR_OUT, .5, .5],
                                        [1.3 * SR_OUT, 1.3 * SR_OUT, .5, .5]],
                   "frames": frames}, f)
    return ckpt, split


def phase_serve(dev, fs, bare_frame_ms: float) -> dict:
    """Serve a driving split from a checkpoint file through the CLI, at
    full width, in three settings (the first one twice, for its rate once
    the process is warm). Returns the quad kernels' launch counts over the
    fast runs."""
    from havatar_tpu_torch.cli import reenact as cli
    from havatar_tpu_torch.cli.common import resolve_config
    from havatar_tpu_torch.data import AvatarDataset
    from havatar_tpu_torch.data.image_io import imread_rgb, imwrite_rgb
    from havatar_tpu_torch.infer.reenact import make_reenact_fn, mean_style
    from havatar_tpu_torch.models.generators import StyleUNetSR
    from havatar_tpu_torch.models.skinning import fix_canonical_volume
    from havatar_tpu_torch.ops import march as M
    from havatar_tpu_torch.train.stage1 import build_renderer
    config = SERVE_CONFIG
    counters = (M.march_coarse, M.march_fine, M.march_coarse_x,
                M.march_fine_x)
    total = {"march_coarse": 0, "march_fine": 0}
    with tempfile.TemporaryDirectory(prefix="havatar_serve_") as root:
        t0 = time.perf_counter()
        ckpt, split = _write_serving_files(root, fs)
        print(f"[6 serve] wrote {os.path.getsize(ckpt) / 2**20:.1f} MiB "
              f"checkpoint and a split of {SERVE_FRAMES} frames x "
              f"{SERVE_VIEWS} views in {time.perf_counter() - t0:.1f} s",
              flush=True)
        items = [f"{f}_{v:02d}.png" for f in range(SERVE_FRAMES)
                 for v in range(SERVE_VIEWS)]
        pngs = {}
        for what, flags, n in (
                ("fast gated 16+16", ["--precision", "fast", "--gated",
                                      "--coarse", "16"], len(items)),
                # the same again: this process has served these shapes now
                ("fast gated 16+16 again", ["--precision", "fast", "--gated",
                                            "--coarse", "16"], len(items)),
                ("fast blind 64+16", ["--precision", "fast", "--max-frames",
                                      "2"], 2),
                ("exact blind 64+16", ["--precision", "exact",
                                       "--max-frames", "1"], 1)):
            out = os.path.join(root, what.replace(" ", "_"))
            for c in counters:
                c.launches = 0
            stats = cli.main(["--config", config, "--ckpt", ckpt, "--split",
                              split, "--savedir", out] + flags)
            torch.cuda.synchronize()
            fast = what.startswith("fast")
            counts = [c.launches for c in counters]
            _check(stats["frames"] == n, f"{what}: served {stats}")
            _check(counts == ([n, n, 0, 0] if fast else [0, 0, 0, 0]),
                   f"{what}: launches {counts} for {n} frames")
            names = sorted(os.listdir(os.path.join(out, "rgb")))
            _check(names == sorted(items[:n]), f"{what}: files {names}")
            pngs[what] = {k: imread_rgb(os.path.join(out, "rgb", k))
                          for k in names}
            _check(all(v.shape == (SR_OUT, SR_OUT, 3)
                       for v in pngs[what].values()), f"{what}: PNG shapes")
            if n == len(items):
                _check(stats["ray_cache_entries"] == SERVE_VIEWS,
                       f"{what}: ray cache {stats['ray_cache_entries']}")
            if fast:
                total["march_coarse"] += counts[0]
                total["march_fine"] += counts[1]
            print(f"[6 serve] {what}: {json.dumps(stats)}; launches "
                  f"{counts}; bare frame_fn (phase 4, gated 16+16) "
                  f"{1e3 / bare_frame_ms:.2f} frames/s", flush=True)

        again = pngs.pop("fast gated 16+16 again")
        _check(all(np.array_equal(again[k], v)
                   for k, v in pngs["fast gated 16+16"].items()),
               "the second gated run wrote other frames than the first")

        # the first served frame against make_reenact_fn on the same tensors
        cfg = resolve_config(config)
        variables, latents, g_ema, _ = cli.load_inference_weights(ckpt)
        renderer = build_renderer(cfg, compute_dtype=torch.bfloat16,
                                  skin_compute_dtype=None,
                                  use_fused_march=True)
        sr = cfg.models.StyleUnet
        generator = StyleUNetSR(
            inp_size=sr.inp_size, inp_ch=sr.inp_ch, out_size=sr.out_size,
            style_dim=cfg.gan.latent, n_mlp=cfg.gan.n_mlp,
            channel_multiplier=cfg.gan.channel_multiplier,
            compute_dtype=torch.bfloat16)
        renderer.load_state_dict(variables)
        generator.load_state_dict(g_ema)
        renderer, generator = renderer.to(dev).eval(), generator.to(dev).eval()
        frame_fn = make_reenact_fn(renderer, generator, num_coarse=16,
                                   num_fine=16, gated=True)
        ds = AvatarDataset(split, mode="test", cfg=cfg,
                           down_sample=cfg.dataset.down_sample,
                           full_image=True)
        item = ds.load_item(0)
        # the loop's host work on its own, on one thread: an item's decode
        # (six 256^2 PNGs, rays, conditions) and a 512^2 frame's PNG encode
        frame0 = pngs["fast gated 16+16"][items[0]]
        t0 = time.perf_counter()
        for i in range(1, 9):
            ds.load_item(i)
        t1 = time.perf_counter()
        for i in range(8):
            imwrite_rgb(os.path.join(root, "encode.png"), frame0)
        t2 = time.perf_counter()
        print(f"[6 serve] host work alone, mean of 8: load_item "
              f"{(t1 - t0) / 8 * 1e3:.2f} ms, imwrite_rgb of a 512^2 frame "
              f"{(t2 - t1) / 8 * 1e3:.2f} ms", flush=True)

        # batched as the loader batches (np.stack: a dense batch axis). The
        # same values with another stride on the size-1 batch axis (numpy's
        # a[None]) take another route through the bf16 layers, and the frame
        # then differs by bf16 rounding: up to 3 of 255 on 17% of the values
        # on an H100.
        def t(k, lo=0, hi=None):
            return torch.from_numpy(np.stack([item[k]])[..., lo:hi]).to(dev)

        with torch.inference_mode():
            vol = fix_canonical_volume(renderer.skin_volume())
        direct = frame_fn(
            vol, mean_style(cfg.gan.latent, seed=cfg.experiment.randomseed,
                            device=dev),
            t("mv_rays", 0, 8), t("mv_rays", 8, 11),
            latents[0:1].to(dev), t("inv_head_T"),
            t("front_render_cond"), t("left_render_cond"),
            t("right_render_cond"))[0].cpu().numpy()
    served = pngs["fast gated 16+16"][items[0]]
    diff = np.abs(served.astype(np.int16) - direct.astype(np.int16))
    inside = float(((direct > 0) & (direct < 255)).mean())
    print(f"[6 serve] {items[0]} from its PNG vs make_reenact_fn on the same "
          f"tensors: max abs diff {int(diff.max())} of 255, "
          f"{float((diff > 0).mean()):.2e} of the values differ; "
          f"{inside:.3f} of the values lie strictly inside (0, 255)",
          flush=True)
    _check(int(diff.max()) <= 1, f"served frame differs by {diff.max()}")
    _check(inside > 0.05, "served frames are clamped almost everywhere")
    a = torch.from_numpy(pngs["exact blind 64+16"][items[0]] / 255.0)
    b = torch.from_numpy(pngs["fast blind 64+16"][items[0]] / 255.0)
    g = torch.from_numpy(served / 255.0)
    db = _psnr(a, b)
    print(f"[6 serve] {items[0]}: exact float32 vs fast bf16, both blind "
          f"64+16: {db:.2f} dB (bar {SERVE_MIN_PSNR_DB}); fast gated 16+16 "
          f"vs exact blind 64+16: {_psnr(a, g):.2f} dB", flush=True)
    _check(db >= SERVE_MIN_PSNR_DB, f"exact vs fast frame {db:.2f} dB")
    return total


def phase_kernel_line(captured, launches, serve_launches) -> list:
    """Each kernel on the inputs the frame gave it: error against its twin,
    its time and the twin's (CUDA events), and its bound. ``launches`` is
    the count over the five frames of the kernel's own configuration;
    ``launches_serve`` the count over the CLI's fast runs (quad kernels)."""
    from havatar_tpu_torch.ops import march as M
    rows = []
    for name, kernel, plain, compare, bound_fn, replaces in (
            ("march_coarse", M.march_coarse, M.march_coarse_plain,
             compare_coarse, coarse_bound,
             "havatar_tpu/ops/pallas_march.py:236"),
            ("march_fine", M.march_fine, M.march_fine_plain, compare_fine,
             fine_bound, "havatar_tpu/ops/pallas_march.py:403"),
            ("march_coarse_x", M.march_coarse_x, M.march_coarse_x_plain,
             compare_coarse, coarse_bound,
             "havatar_tpu/ops/pallas_march.py:194"),
            ("march_fine_x", M.march_fine_x, M.march_fine_x_plain,
             compare_fine, fine_bound,
             "havatar_tpu/ops/pallas_march.py:356")):
        a, kw = captured[name]
        with torch.inference_mode():
            got = kernel(*a, **kw)
            torch.cuda.synchronize()
            errs = compare(got, plain(*a, **kw), "phase 7")
            ms = _time_ms(lambda: kernel(*a, **kw))
            plain_ms = _time_ms(lambda: plain(*a, **kw), iters=5)
        bound, by = bound_fn(a, got)
        rows.append({
            "name": name, "route": "cuda",
            "source": "havatar_tpu_torch/csrc/march.cu", "replaces": replaces,
            "launches": launches[name],
            "launches_per_frame": launches[name] / N_FRAMES,
            "launches_serve": serve_launches.get(name, 0),
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
    fs, inputs, frames, launches, captured = phase_frames(dev)
    frame_ms = phase_timing(fs, inputs)
    phase_profile(fs, inputs, frame_ms)
    fs_x, launches_x, captured_x = phase_frames_reduced(dev, inputs, fs,
                                                        frames)
    phase_timing(fs_x, inputs, tag="5 reduced", suffix="_x")
    del fs_x, frames
    serve_launches = phase_serve(dev, fs, frame_ms)
    rows = phase_kernel_line({**captured, **captured_x},
                             {**launches, **launches_x}, serve_launches)
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.1f} s",
          flush=True)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
