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
   rays, 16 coarse and 16 fine samples, C = 64) on seeded inputs (the quad
   pair: two 128^2 x 64 bf16 planes, points a little past the sampling
   cube, their cells and aux), two quad launches bit for bit; the
   reduced-input pair also against the quad pair on the same points; then
   the micro entry point ``havatar_tpu_torch.scripts.micro_march.main``
   (both kernels gated 16 + 16 and blind 64 + 16, beside the input
   stage's PyTorch pieces).
3. the production golden scene (``tests/golden/render_production.npz``):
   all 16384 rays, blind 64+16, through the renderer's three
   configurations (fused on corner rows, fused on the reduced input, exact
   float32); each one's PSNR against the reference render.
4. frames: the full-width flagship (two 256^2 -> 128^2 x 64 plane
   generators, gated 16+16 march, StyleUNetSR 128^2 -> 512^2) serves five
   frames with seeded conditions and head poses; the launch counters show
   both quad kernels ran once a frame, and the counters of the two
   corner-row gathers (``grid_sample_2d_quad``, ``gather_rows``) that no
   [R, S, 8C] tensor was made: the kernels gather from the planes; one
   frame is rendered again with the twins; frames/s and per-stage times
   from CUDA events; the device's busy time and idle share a frame from a
   torch.profiler trace.
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
7. the dense-chain kernels (``csrc/mlp.cu``: forward and backward, float32
   and bf16; the backward on ``csrc/chain_bwd.cuh``'s body) vs their plain
   twins on seeded inputs at N = 524,288 and 131,072 rows (a stage-1 step's
   coarse and fine calls), 32,768 and an N no tile divides (100,003); two
   backward launches at 524,288 must give the same dx and parameter
   gradients bit for bit; timed at 524,288 and at 1,048,576 (stage 2's
   rows), with the bound on the kernels' route (float32: split TF32, the
   backward's recompute on FFMA) beside the bound on FFMA alone.
8. train: a seeded training set (512^2 target images and masks, two
   cameras, eight frames, condition PNGs) is written to a temporary
   directory and trained on through ``havatar_tpu_torch.cli.train_avatar.
   main`` at the full width of the built-in ``singleview_512_base.yml``
   with ``models.use_pallas_mlp: true`` and only the cadences shortened:
   the skinning pretraining, 30 steps of 2 frames x 4096 rays (one 64 x 64
   patch a frame), 64 + 16 samples, two 512^2 validation renders, a
   checkpoint, then a second run that resumes from it. The pretraining's
   BCE and the loss must fall, and the dense-chain kernels must have run
   twice forward and twice backward a step (plus the validation renders').
   One step through the kernels is held against the same step through the
   twins on the same draws and fine samples, gradient by gradient, with
   cuDNN's deterministic algorithms (``deterministic_convs``). A few
   steps in bf16 and a few without the fused chain follow for the record;
   then the step's time with and without the fused chain in turns, its
   split by CUDA events and a torch.profiler trace of 5 steps.
9. stage 2: the quad field kernels (``csrc/quad.cu``: forward and
   backward, float32 and bf16; they gather the corner texels from the
   planes and splat the plane gradients themselves) against their twins on
   seeded inputs at N = 262,144 and 100,003, plane gradients included, and
   two backward launches bit for bit; then training through
   ``havatar_tpu_torch.cli.train_avatarHD.main`` at the full width of the
   built-in ``singleview_512_HD_base.yml`` with
   ``models.use_pallas_mlp_quad: true`` and only the cadences shortened
   (128^2 render of 2 items, 64 + 16 samples, StyleUNetSR 128^2 -> 512^2,
   the 512^2 wavelet discriminator, float32), warm-started from phase 8's
   checkpoint on phase 8's set: 10 iterations of D, R1 (at iteration 0)
   and G steps with a g_ema sample grid, the quad kernels exactly 4 + 4
   launches a G step plus 4 a D render and a sample grid, the NeRF's psnr
   not falling; a resume for 2 iterations; 3 ``--fast-step`` and 3
   ``--turbo`` (bf16) iterations for the record; one G step through the
   kernels held against the same step through the twins, gradient by
   gradient (deterministic cuDNN, as in phase 8); an iteration's time, its split by CUDA events, the peak
   device memory and a torch.profiler trace; the trained checkpoint
   served for two items through ``havatar_tpu_torch.cli.reenact.main``.
10. the field kernel (``csrc/mlp.cu``'s ``field_eval_*``: posenc in the
   kernel, then the chain; float32 and bf16), which no serving or training
   path runs (its launch count after phases 4 to 9 must be 0): against its
   twin on seeded points (|p| up to 5) at N = 1,310,720 (the micro shape)
   and 100,003; on the golden scene's trained field, on the exact float32
   renderer's coarse-pass points (16384 rays x 64 samples), against
   ``field.forward`` in float32 and its twin in bf16; then its micro entry
   point ``havatar_tpu_torch.scripts.micro_field.main`` at N = 1,310,720.
   Launch counts equal the calls made.
11. one JSON line listing each kernel: launches, error against its twin,
   its time, the twin's time and its bound on this card on the route its
   products take (``products``: bf16 tensor cores, FFMA, or split TF32
   with the backward's recompute on FFMA; the float32 rows also give the
   bound on the other float32 route); the dense-chain,
   quad and field rows also carry the time of the unfused chain (five
   ``F.linear`` calls, for the quad rows after the bilinear gathers and
   for the field rows after posenc, and autograd's backward); the quad rows
   also the whole op's time (``op_ms``: the differentiable op's forward,
   or its backward, the corner weights' autograd included) and the PyTorch
   pieces of the composition the kernels replace (``gather_ms``: the corner
   rows' gather; ``regather_splat_ms``: the gather again and the splat of
   an [N, 8C] gradient with ``index_add_``); the quad march rows, on the
   frame's captured calls, their input stage's time (``stage_ms``:
   ``field_inputs_cells``), the stage with the kernel (``op_ms``), the
   corner-rows stage of the old contract (``gather_ms``:
   ``field_inputs_quad``) and the bound had the kernel read those corner
   rows (``bound_old_contract_ms``).

12. preprocessing (run after phase 10, before phase 11's line is
   printed): a seeded FaceVerse v3.1 dict at the reference's shapes (id
   150, exp 171 and a 52-expression base, tex 251, 478 MediaPipe
   keypoints; a closed head of 19,794 vertices whose last two vertex
   ranges are two eyeballs), a 512^2 MJPG video of 14 frames, precomputed
   landmarks (the model's projection at a drifting pose, plus noise) and
   masks, all in a temporary directory; then
   ``havatar_tpu_torch.cli.fit_video.main`` at its defaults (512^2, 2000
   iterations on frame 0, 100 on the others, base frame 10). Frame 0's
   loss must fall tenfold, every frame get its three nonblank renders,
   the split hold frames 10 to 13 and an item of it load through
   ``AvatarDataset`` with finite rays; frame 0's front-view rasterization
   and a 100-iteration fit of frame 11 on the card are held against the
   same calls on the CPU; it prints the fit's seconds (frame 0, a later
   frame), the renders', the rasterizer's ms a view (its chunk windows
   against the dense form JAX takes, which must give the same images, on
   the head's ring-by-ring face order and on a seeded random one), the
   fit's launches, device busy time and host time an iteration
   (torch.profiler) and the CLI's peak device memory above what was live
   before it. Then the heads: the flagship-width field with
   ``sh_deg = 2`` forward and backward on 16,384 x 32 points (the first
   4096 against the CPU), the 512^2 discriminator with ``c_dim = 25`` at
   batch 2 (batch 1 against the CPU) and 2D ``border`` padding against
   ``F.grid_sample``.
13. the preprocessing networks (run after phase 12, beside its inputs,
   before phase 11's line is printed), on seeded weights in the
   reference's key layouts, at full width, each on the card against the
   same module on the CPU (TF32 off; the bounds ``NET_TOL`` and the rest,
   from JAX's own tests): OpenSeeFace's landmark net, model types 0 to 3,
   on 4 crops of 224^2 (the maps, and the decoded landmarks in pixels;
   timed at 1 and 4 crops), the detection net at 224^2, the gaze net on
   two 32^2 eye crops and RetinaFace at 640^2; RVM over phase 12's
   14-frame 512^2 video at downsample ratio 0.25 carrying its recurrent
   state (foreground, alpha and all four states, every frame) and frame 0
   at 1.0; the tracker (landmark type 3, the detection and gaze nets, head
   pose, features) over the 14 frames, whose seeded heads give a
   confident face in frame 0; ``onnx_rt`` on a graph built in code; then
   ``havatar_tpu_torch.cli.fit_video.main`` with ``--lm_weights``,
   ``--detect_weights`` and ``--rvm_path ... --rvm_jax`` on seeded weight
   files and phase 12's inputs, the fit shortened to 100 + 20 iterations
   (phase 12 runs it at its defaults): the crop, every mask nonblank, the
   split. It prints each net's ms a call, RVM's frames/s, the tracker's ms
   a frame, RVM's and the tracker's launches, device busy time and idle
   share a frame (torch.profiler), the phase's peak device memory and its
   seconds, beside the card's name and power limit.

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
# float32 products as split TF32 on the tensor cores (three TF32 products,
# 495 TFLOP/s dense, for one): the rate of the float32 chain kernels'
# tensor-core products (csrc/chain_bwd.cuh)
TF32_SPLIT_OPS_S = 495e12 / 3

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

# dense-chain kernels vs twins (tests/test_torch_mlp_cuda.py states the same
# bounds). float32: summation order only; forward atol 2e-4, rtol 2e-3,
# gradients atol 1e-4 * max(1, |want|max), rtol 1e-4. bf16: a hidden
# activation can round to its other bf16 neighbour, which moves an output by
# about 2^-8 of the activations' scale: forward atol 3e-2, rtol 3e-2;
# gradients by their relative L2 error, 2e-2.
MLP_F32_FWD_TOL = dict(atol=2e-4, rtol=2e-3)
MLP_F32_GRAD_ATOL, MLP_F32_GRAD_RTOL = 1e-4, 1e-4
MLP_BF16_FWD_TOL = dict(atol=3e-2, rtol=3e-2)
MLP_BF16_GRAD_REL_L2 = 2e-2
MLP_TAIL_N = 100003                           # no tile divides it
# a stage-1 step's coarse and fine calls (2 x 4096 rays, 64 + 16 samples),
# a smaller N and a ragged one
MLP_NS = (524288, 131072, 32768, MLP_TAIL_N)
MLP_STAGE2_N = 128 * 128 * 64                 # a stage-2 generator step's rows

TRAIN_CONFIG = "singleview_512_base.yml"      # built into the port
TRAIN_FRAMES, TRAIN_VIEWS = 8, 2
TRAIN_STEPS, TRAIN_PRETRAIN, TRAIN_EVERY = 30, 200, 10
TRAIN_RECORD_STEPS = 6                        # the bf16 and the unfused run
# a whole step's gradients, kernels against twins on the same draws and fine
# samples: per tensor, within this share of the tensor's largest entry (plus
# 1e-6 of the largest gradient entry of all, for tensors whose true gradient
# is zero). Summation order in the chain, carried through the backward of
# the plane generators, and the atomics of the other ops' backward.
TRAIN_GRAD_REL = 1e-3


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


def _bound_ms(nbytes: int, tc_ops: float, f32_ops: float,
              split_ops: float = 0.0):
    """Least time on an H100 for the work: the larger of bytes over HBM
    rate and operations over their peak rates (bf16 tensor cores, FFMA,
    split TF32)."""
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = (tc_ops / BF16_TC_OPS_S + f32_ops / F32_OPS_S
             + split_ops / TF32_SPLIT_OPS_S)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _mlp_ops(n: int, mp, quad: bool = True):
    """(tensor-core ops, f32 ops) of the field MLP on n samples; with
    ``quad`` including the f32 corner reduction of their 8 corner texels."""
    fin, hid = mp.w0.shape[1], mp.w0.shape[0]
    cf = mp.wr.shape[1]
    c = (fin - N_PE) // 2
    tc = 2.0 * n * (fin * hid + hid * hid + hid * (cf + 1) + cf * 3)
    return tc, 2.0 * n * 8 * c if quad else 0.0


def _input_bytes(xs, old_contract: bool = False) -> int:
    """Bytes of a march kernel's input stage: the planes, cells and aux of
    the quad pair (``old_contract``: the [R, S, 8C] bf16 corner rows and aux
    that the corner-rows contract read instead), or the reduced input."""
    if len(xs) == 1:
        return _nbytes(*xs)
    pxy, pzy, rows, aux = xs
    if old_contract:
        R, S, _ = rows.shape
        return R * S * 8 * pxy.shape[-1] * 2 + _nbytes(aux)
    return _nbytes(pxy, pzy, rows, aux)


def coarse_bound(args, outs, old_contract: bool = False):
    """Bound of either coarse kernel from its own call's arguments:
    (plane_xy, plane_zy, rows, aux, dists, mp) or (x, dists, mp)."""
    *xs, dists, mp = args
    R, S = dists.shape
    cf = mp.wr.shape[1]
    tc, f32 = _mlp_ops(R * S, mp, quad=len(xs) == 4)
    f32 += R * S * (10 + 2 * (3 + cf))   # alpha, transmittance, weighted sums
    return _bound_ms(_input_bytes(xs, old_contract)
                     + _nbytes(dists, *mp.tensors(), *outs), tc, f32)


def fine_bound(args, outs, old_contract: bool = False):
    """Bound of either fine kernel: (plane_xy, plane_zy, rows_new, aux_new,
    keeps, d_concat, ranks, mp[, num_keep]) or (x_new, keeps, d_concat,
    ranks, mp[, num_keep])."""
    args = [a for a in args if not isinstance(a, int)]
    *xs, keeps, d_concat, ranks, mp = args
    R, Sa = d_concat.shape
    Sn = xs[-1].shape[1]
    cf = mp.wr.shape[1]
    tc, f32 = _mlp_ops(R * Sn, mp, quad=len(xs) == 4)
    f32 += R * Sa * (10 + 2 * (3 + cf) + 2)  # + the product in rank order
    return _bound_ms(_input_bytes(xs, old_contract)
                     + _nbytes(keeps, d_concat, ranks, *mp.tensors(), *outs),
                     tc, f32)


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
def deterministic_convs():
    """cuDNN's deterministic algorithms inside the block. A whole training
    step run twice on the same inputs then gives the same gradients bit for
    bit, so a step through the kernels held against the same step through
    their twins sees the kernels' differences alone: otherwise the
    convolutions' backward by itself moves a gradient that sums over every
    pixel (a StyledConv's scalar noise weight) by as much as the kernels
    do."""
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved


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
    cuda_build.build(["march", "mlp", "quad"])  # one nvcc each, side by side
    print(f"[1 device] built csrc/march.cu, csrc/mlp.cu and csrc/quad.cu in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name in ("march", "mlp", "quad"):
        for line in cuda_build.build_logs.get(name, "").splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  ptxas ({name}):", line.strip())


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


def _reduce_interleave(xs):
    """The reduced MLP input of the quad pair's points (``xs``: plane_xy,
    plane_zy, rows, aux), as ``grid_sample_2d`` rounds it (f32 corner sums
    rounded to bf16), un-permuted to the reference's interleaved channel
    order."""
    from havatar_tpu_torch.ops import march as M
    rows, aux = xs[2:]
    R, S = rows.shape[:2]
    quads = M.gather_quads(*xs[:3])
    xb = M._build_x(quads.reshape(R * S, -1), aux.reshape(R * S, -1), C, N_PE)
    planes = torch.stack([xb[:, :C], xb[:, C:2 * C]], -1).flatten(-2)
    return torch.cat([planes, xb[:, 2 * C:]], -1).reshape(R, S, -1).contiguous()


def _quad_inputs(gen, dev, R, S, planes=None):
    """The quad pair's input stage on seeded points: two production-size
    bf16 planes (``planes`` if given), points over the sampling cube and a
    little past it, their cells and aux = posenc ++ corner weights."""
    from havatar_tpu_torch.ops import mlp_quad as Q
    if planes is None:
        planes = tuple(torch.randn(1, QUAD_PLANE, QUAD_PLANE, C,
                                   generator=gen).bfloat16().to(dev)
                       for _ in range(2))
    warped = torch.rand(R * S, 3, generator=gen) * 2.1 - 1.05
    rows, w8 = Q.quad_rows(warped, QUAD_PLANE, QUAD_PLANE)
    pe = torch.sin(torch.randn(R, S, N_PE, generator=gen) * 3)
    aux = torch.cat([pe, w8.reshape(R, S, 8)], -1)
    return (*planes, rows.reshape(R, S, 2).to(dev), aux.to(dev))


def _merge_ranks(a, b):
    """Comparison-count merge ranks of two ascending lists (the renderer's
    rule: a before an equal b)."""
    pa = torch.arange(a.shape[1]) + (b[:, None, :] < a[:, :, None]).sum(-1)
    pb = torch.arange(b.shape[1]) + (a[:, :, None] <= b[:, None, :]).sum(1)
    return torch.cat([pa, pb], -1).to(torch.int32)


def phase_kernels(dev) -> None:
    from havatar_tpu_torch.ops import march as M
    from havatar_tpu_torch.scripts import micro_march
    gen = torch.Generator().manual_seed(0)
    R, S, Sn, Sk = R_FRAME, S_COARSE, S_FINE, S_COARSE // 2
    mp, mp_x = _march_params(gen, dev, alpha_bias=1.0)
    xs = _quad_inputs(gen, dev, R, S)
    # a per-ray scale on the deltas spreads acc = sum(weights) over (0, 1)
    dists = (torch.rand(R, 1, generator=gen) * 0.3
             * (0.5 + torch.rand(R, S, generator=gen))).to(dev)
    got = M.march_coarse(*xs, dists, mp)
    torch.cuda.synchronize()
    want = M.march_coarse_gather_plain(*xs, dists, mp)
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
    xs_new = _quad_inputs(gen, dev, R, Sn, planes=xs[:2])
    args = (*xs_new, want[2], d_concat, ranks, mp, Sk)
    got_f = M.march_fine(*args)
    torch.cuda.synchronize()
    want_f = M.march_fine_gather_plain(*args)
    acc = want_f[1].sum(-1)
    print(f"[2 kernels] fine acc min/mean/max {float(acc.min()):.4f} "
          f"{float(acc.mean()):.4f} {float(acc.max()):.4f}")
    errs["march_fine"] = compare_fine(got_f, want_f, "phase 2")
    # the march has no atomics: a second launch gives the same bits
    again, again_f = M.march_coarse(*xs, dists, mp), M.march_fine(*args)
    torch.cuda.synchronize()
    _check(all(torch.equal(a, b) for a, b in zip((*got, *got_f),
                                                 (*again, *again_f))),
           "phase 2: two launches of the quad kernels differ")

    # kernels 3 and 4 on the same points, reduced as grid_sample_2d does
    x, x_new = _reduce_interleave(xs), _reduce_interleave(xs_new)
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
    del got, want, got_f, want_f, again, again_f, x, x_new, xs, xs_new

    # the micro entry point: both schedules, beside the input stage
    res = micro_march.main([])
    _check(all(math.isfinite(res[k][f"{p}_max_abs_err"])
               for k in micro_march.SCHEDULES for p in ("coarse", "fine")),
           f"micro_march: {res}")
    for k in micro_march.SCHEDULES:
        r = res[k]
        print(f"[2 kernels] micro_march {k} {r['samples']}: coarse "
              f"{r['coarse_ms']:.4f} ms, fine {r['fine_ms']:.4f} ms; input "
              f"stage (cells) {r['cells_ms']:.4f}, + coarse kernel "
              f"{r['stage_coarse_ms']:.4f}, + fine kernel "
              f"{r['stage_fine_ms']:.4f}; the corner-rows stage "
              f"(field_inputs_quad) {r['field_inputs_quad_ms']:.4f}",
              flush=True)


def phase_golden(dev) -> tuple:
    """The golden scene through the renderer's three configurations. The
    two fused ones (bf16 kernels) are held to havatar_tpu's bf16 fused path
    less 1 dB; the exact one (float32) to the JAX package's own bar.
    Returns the exact renderer's field and its coarse pass's arguments
    (canonical points [1, 16384 * 64, 3], planes) for phase 10."""
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
        calls = []    # the exact path's field calls: coarse pass first
        hook = r.model_coarse.register_forward_pre_hook(
            lambda m, args: calls.append(args))
        with torch.inference_mode():
            vol = fix_canonical_volume(r.skin_volume())
            out = r.render_rays(t("planes").to(r.compute_dtype), t("rays"),
                                t("bg"), t("inv_head_T"),
                                num_coarse=int(g["num_coarse"]),
                                num_fine=int(g["num_fine"]), fixed_volume=vol)
        hook.remove()
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
            can, _, planes = calls[0]
            coarse = (r.model_coarse, can, planes)
    return coarse


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
    from havatar_tpu_torch.ops.grid_sample import grid_sample_2d_quad
    from havatar_tpu_torch.ops.mlp_quad import gather_rows

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
    grid_sample_2d_quad.calls = gather_rows.calls = 0
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
    # the kernels gather the corner texels: no [R, S, 8C] corner rows
    corner_rows = {"grid_sample_2d_quad": grid_sample_2d_quad.calls,
                   "gather_rows": gather_rows.calls}
    _check(not any(corner_rows.values()),
           f"the frame path built corner rows: {corner_rows}")
    print(f"[4 frames] served {N_FRAMES} frames; launches {launches}; "
          f"corner-row gathers {corner_rows}", flush=True)

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
    # where the fine samples are the main path's; phase 11 holds the coarse
    # kernel to its twin on this frame's own inputs.
    # The twins' run also keeps the points and planes that the field's
    # input stage took (phase 11 times it against the corner-rows stage).
    captured, stages = {}, []
    field = fs.renderer.model_coarse

    def plain_coarse(*a, **kw):
        captured["march_coarse"] = (a, kw)
        return M.march_coarse_gather_plain(*a, **kw)

    def plain_fine(*a, **kw):
        captured["march_fine"] = (a, kw)
        return M.march_fine_gather_plain(*a, **kw)

    def cells(pts, planes):
        stages.append((cells_fn, field.field_inputs_quad, pts, planes))
        return cells_fn(pts, planes)

    cells_fn = field.field_inputs_cells

    render_kernel, mask_kernel = renders[0]
    renders.clear()
    field.field_inputs_cells = cells
    with marches(plain_coarse, plain_fine):
        img_plain = fs.frame_fn(**inputs[0])
    del field.field_inputs_cells
    captured["stages"] = {"march_coarse": stages[0], "march_fine": stages[1]}
    with marches(M.march_coarse, M.march_fine_gather_plain):
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


def profile_device(run, n: int, unit_ms: float, tag: str, unit: str) -> None:
    """Device busy time a ``unit`` (a frame, a step): the summed device time
    of every kernel, copy and fill in a torch.profiler trace of ``n`` calls
    of ``run(i)``, against the host clock's unprofiled time a unit (the rest
    is the device's idle share), and the kernels that take the most of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            run(i)
        torch.cuda.synchronize()
    on_dev = sorted((e for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA),
                    key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in on_dev) / 1e3 / n
    if not busy_ms:
        print(f"[{tag}] device busy time: not measured (the profiler "
              "recorded no device activity)", flush=True)
        return
    print(f"[{tag}] device busy {busy_ms:.4f} ms a {unit} of "
          f"{unit_ms:.4f} ms on the host clock: idle share "
          f"{1 - busy_ms / unit_ms:.4f} (torch.profiler, {n} "
          f"{unit}s); device launches a {unit} "
          f"{sum(e.count for e in on_dev) / n:.1f}", flush=True)
    for e in on_dev[:12]:
        print(f"  {e.self_device_time_total / 1e3 / n:8.4f} ms "
              f"{e.count / n:6.1f}x  {e.key[:100]}")


def phase_profile(fs, inputs, frame_ms: float) -> None:
    profile_device(lambda i: fs.frame_fn(**inputs[i]), N_FRAMES, frame_ms,
                   "4 frames", "frame")


def _target_image(f: int, v: int):
    """A seeded 512^2 training target: a smooth, tinted ellipse (the mask)
    that shifts with the frame and the view. Returns (rgb uint8, mask
    uint8), both [512, 512, 3]."""
    yy, xx = np.mgrid[0:SR_OUT, 0:SR_OUT].astype(np.float32) / (SR_OUT - 1)
    cx, cy = 0.5 + 0.04 * (v - 0.5) + 0.01 * math.sin(f), 0.5 + 0.01 * f / 8
    inside = ((xx - cx) / 0.27) ** 2 + ((yy - cy) / 0.36) ** 2 < 1.0
    rgb = np.stack([0.80 - 0.30 * yy, 0.50 + 0.25 * xx,
                    0.45 + 0.10 * np.sin(6.0 * yy + f)], -1)
    mask = np.repeat(inside[..., None], 3, -1)
    return ((rgb * 255.0 + 0.5).astype(np.uint8),
            mask.astype(np.uint8) * 255)


def _write_split(root: str, rng, n_frames: int, targets: bool) -> str:
    """A split in the reference's ``sv_v31_all.json`` format under ``root``:
    512^2 frames, two cameras, ``n_frames`` frames with seeded head poses
    and six seeded 256^2 condition PNGs each; with ``targets`` also every
    view's target image and mask (what a training item reads). Returns the
    split's path."""
    from havatar_tpu_torch.data.image_io import imwrite_rgb

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
    for f in range(n_frames):
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
        views = []
        for v, (c2w, ori) in enumerate(cams):
            info = {"view_name": str(v), "transform_matrix": c2w,
                    "transform_matrix_ori": ori}
            if targets:
                rgb, mask = _target_image(f, v)
                info["file_path"] = os.path.join(root, f"frame_{f}_{v}.png")
                info["mask_path"] = os.path.join(root, f"mask_{f}_{v}.png")
                imwrite_rgb(info["file_path"], rgb)
                imwrite_rgb(info["mask_path"], mask)
            views.append(info)
        frames.append({"fidx": f, "head_transformation": head.tolist(),
                       "inst_dir": inst, "mutiview_info_ls": views})
    split = os.path.join(root, "sv_v31_all.json")
    with open(split, "w") as f:
        json.dump({"img_res": SR_OUT,
                   "mutiview_intr_ls": [[1.2 * SR_OUT, 1.2 * SR_OUT, .5, .5],
                                        [1.3 * SR_OUT, 1.3 * SR_OUT, .5, .5]],
                   "frames": frames}, f)
    return split


def _write_serving_files(root: str, fs) -> tuple:
    """A stage-2 checkpoint of the flagship's seeded modules with seeded
    latent codes, and a driving split of SERVE_FRAMES frames (see
    ``_write_split``). Returns (checkpoint, split)."""
    from havatar_tpu_torch.checkpoints.stage2 import stage2_checkpoint
    rng = np.random.RandomState(7)
    latents = torch.from_numpy(
        (rng.randn(SERVE_FRAMES, 32) * 0.5).astype(np.float32))
    ckpt = os.path.join(root, "latest.pt")
    torch.save(stage2_checkpoint(fs.renderer, fs.generator, latents, 0), ckpt)
    return ckpt, _write_split(root, rng, SERVE_FRAMES, targets=False)


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


# ---------------------------------------------------------------------------
# the dense chain (csrc/mlp.cu) and stage-1 training
# ---------------------------------------------------------------------------

MLP_GRAD_NAMES = ("dx", "w0", "b0", "w1", "b1", "w_feat", "b_feat", "w_alpha",
                  "b_alpha", "w_rgb", "b_rgb")


def _mlp_macs() -> tuple:
    """Multiply-adds a row, (forward, backward): the backward recomputes the
    three hidden products, runs the transposed chain and contracts every
    weight gradient."""
    from havatar_tpu_torch.ops.mlp import CF, FIN, HID
    l0, l1, lf = FIN * HID, HID * HID, HID * CF
    fwd = l0 + l1 + lf + HID + CF * 3
    return fwd, (l0 + l1 + lf) + fwd + fwd


def chain_ops(n: int, backward: bool, route: str) -> tuple:
    """Operations of the dense chain on n rows by the rate they run at:
    (bf16 tensor cores, FFMA, split TF32). ``route`` "bf16": every product
    on bf16 tensor cores; "ffma": every product on FFMA; "split" (the
    float32 kernels of csrc/mlp.cu and the quad backward): the three wide
    products on split TF32, except the backward's recompute of them on
    FFMA; the heads' small products (fc_alpha, fc_rgb) on FFMA."""
    from havatar_tpu_torch.ops.mlp import CF, FIN, HID
    fwd, bwd = _mlp_macs()
    macs = bwd if backward else fwd
    if route == "bf16":
        return 2.0 * n * macs, 0.0, 0.0
    if route == "ffma":
        return 0.0, 2.0 * n * macs, 0.0
    wide = FIN * HID + HID * HID + HID * CF
    split = 2 * wide if backward else wide
    return 0.0, 2.0 * n * (macs - split), 2.0 * n * split


def mlp_route(dtype) -> str:
    """The products' route of the dense-chain kernels for x in dtype."""
    return "bf16" if dtype == torch.bfloat16 else "split"


def mlp_bound(x, params, backward: bool, route: str = None):
    """Bound of a dense-chain kernel from its call's arguments: x, the
    parameters and the [N, 68] float32 output move once (the backward reads
    that much cotangent and also writes dx and the parameter gradients); the
    products run at the rates of ``route`` (by default the kernels' own)."""
    n = x.shape[0]
    nbytes = _nbytes(x, *params) + n * 68 * 4
    if backward:
        nbytes += _nbytes(x, *params)
    return _bound_ms(nbytes, *chain_ops(n, backward,
                                        route or mlp_route(x.dtype)))


def _mlp_params(gen, dev) -> tuple:
    """The five layers at LeCun-normal scale (activations of order 1)."""
    from havatar_tpu_torch.ops.mlp import CF, FIN, HID
    out = []
    for o, i in ((HID, FIN), (HID, HID), (CF, HID), (1, HID), (3, CF)):
        out.append((torch.randn(o, i, generator=gen) / i ** 0.5).to(dev))
        out.append((torch.randn(o, generator=gen) * 0.2).to(dev))
    return tuple(out)


def compare_mlp_forward(got, want, dtype, where: str) -> float:
    tol = MLP_BF16_FWD_TOL if dtype == torch.bfloat16 else MLP_F32_FWD_TOL
    err = _max_err(got, want)
    _check(got.shape == want.shape and got.dtype == torch.float32
           and torch.allclose(got, want, **tol),
           f"{where}: forward max abs err {err}")
    return err


def compare_backward(got, want, names, dtype, where: str,
                     per_row=None) -> dict:
    """A backward kernel's outputs against the twin's, tensor by tensor: the
    largest absolute error and the largest relative L2 error. bf16 by the
    relative L2; float32 atol 1e-4 * max(1, |want|max), rtol 1e-4, except
    that ``per_row`` (name -> rows allowed) lets a tensor of rows (a row a
    point, or a plane gradient's texels) have that many rows off: one point
    in 10,000 may have a hidden unit on the other side of the ReLU's kink,
    and such a point moves up to 4 texels of each plane
    (tests/test_torch_quad_cuda.py); the largest count of such rows is
    ``kink_rows``."""
    per_row = per_row or {}
    worst = {"max_abs_err": 0.0, "max_rel_l2": 0.0}
    if per_row:
        worst["kink_rows"] = 0
    for name, a, b in zip(names, got, want):
        _check(a.shape == b.shape and a.dtype == b.dtype,
               f"{where}: {name} is {tuple(a.shape)} {a.dtype}")
        a, b = a.float(), b.float()
        err = _max_err(a, b)
        rel = float((a - b).norm() / b.norm().clamp_min(1e-12))
        if dtype == torch.bfloat16:
            ok = rel < MLP_BF16_GRAD_REL_L2
        else:
            tol = dict(atol=MLP_F32_GRAD_ATOL * max(1.0, float(b.abs().max())),
                       rtol=MLP_F32_GRAD_RTOL)
            if name in per_row:
                bad = int((~torch.isclose(a, b, **tol)).reshape(
                    -1, a.shape[-1]).any(1).sum())
                worst["kink_rows"] = max(worst["kink_rows"], bad)
                ok = bad <= per_row[name]
            else:
                ok = torch.allclose(a, b, **tol)
        _check(ok, f"{where}: {name} max abs err {err}, relative L2 {rel}")
        worst["max_abs_err"] = max(worst["max_abs_err"], err)
        worst["max_rel_l2"] = max(worst["max_rel_l2"], rel)
    return worst


def compare_mlp_backward(got, want, dtype, where: str) -> dict:
    """(dx, grads) of the dense-chain backward kernel against the twin's."""
    return compare_backward((got[0], *got[1]), (want[0], *want[1]),
                            MLP_GRAD_NAMES, dtype, where)


def mlp_timings(x, g, params) -> dict:
    """CUDA-event times at one call's arguments: the two kernels and the
    unfused chain (``scripts/micro_mlp.py``'s timings), their twins, and
    the bounds on the kernels' route and on FFMA alone."""
    from havatar_tpu_torch.ops import mlp as M
    from havatar_tpu_torch.scripts import micro_mlp
    with torch.no_grad():
        t = micro_mlp.timings(x, g, params, x.device)
        it_plain = 2 if x.shape[0] > 500_000 else 5
        t["fwd_plain_ms"] = _time_ms(
            lambda: M.fused_mlp_chain_plain(x, *params), it_plain, 1)
        t["bwd_plain_ms"] = _time_ms(
            lambda: M.fused_mlp_chain_bwd_plain(x, g, *params), it_plain, 1)
    for d, backward in (("fwd", False), ("bwd", True)):
        (t[f"{d}_bound_ms"], t[f"{d}_bound_by"]) = mlp_bound(x, params,
                                                             backward)
        if x.dtype == torch.float32:
            t[f"{d}_bound_ffma_ms"] = mlp_bound(x, params, backward,
                                                "ffma")[0]
    return t


def _grads_bit_identical(x, g, params, where: str) -> None:
    """Two backward launches on the same inputs: the same dx and parameter
    gradients bit for bit (no atomics)."""
    from havatar_tpu_torch.ops import mlp as M
    with torch.no_grad():
        a = M.mlp_backward(x, g, *params)
        b = M.mlp_backward(x, g, *params)
    torch.cuda.synchronize()
    _check(torch.equal(a[0], b[0]) and all(
        torch.equal(p, q) for p, q in zip(a[1], b[1])),
        f"{where}: two backward launches differ in dx or a parameter "
        f"gradient")


def phase_mlp_kernels(dev) -> None:
    """Kernels 5 and 6 against their twins on seeded inputs, float32 and
    bf16, at 524,288 and 131,072 rows (a stage-1 step's coarse and fine
    calls), 32,768 and a ragged N; two backward launches bit for bit; times
    at 524,288 and at 1,048,576 (stage 2's rows, which no path here runs
    through this op)."""
    from havatar_tpu_torch.ops import mlp as M
    from havatar_tpu_torch.ops.mlp import FIN
    gen = torch.Generator().manual_seed(5)
    params = _mlp_params(gen, dev)
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        for n in MLP_NS:
            where = f"phase 7, {name}, N = {n}"
            x = torch.randn(n, FIN, generator=gen).to(dev).to(dtype)
            g = torch.randn(n, 68, generator=gen).to(dev)
            with torch.no_grad():
                got = M.mlp_forward(x, *params)
                torch.cuda.synchronize()
                err_f = compare_mlp_forward(
                    got, M.fused_mlp_chain_plain(x, *params), dtype, where)
                got_b = M.mlp_backward(x, g, *params)
                torch.cuda.synchronize()
                err_b = compare_mlp_backward(
                    got_b, M.fused_mlp_chain_bwd_plain(x, g, *params), dtype,
                    where)
            print(f"[7 mlp] {name} N = {n}: forward max abs err {err_f:.3g}; "
                  f"backward max abs err {err_b['max_abs_err']:.3g}, max "
                  f"relative L2 {err_b['max_rel_l2']:.3g}", flush=True)
            if n == MLP_NS[0]:
                _grads_bit_identical(x, g, params, where)
                print(f"[7 mlp] {name} N = {n}: two backward launches give "
                      f"the same dx and parameter gradients bit for bit",
                      flush=True)
            del x, g, got, got_b
        for n, what in ((MLP_NS[0], "a stage-1 step's coarse call"),
                        (MLP_STAGE2_N, "a stage-2 generator step's rows; "
                                       "timed only")):
            x = torch.randn(n, FIN, generator=gen).to(dev).to(dtype)
            g = torch.randn(n, 68, generator=gen).to(dev)
            t = mlp_timings(x, g, params)
            print(f"[7 mlp] {name} N = {n} ({what}; bounds on the kernels' "
                  f"route, {mlp_route(dtype)}, and on FFMA alone): "
                  + json.dumps({k: round(v, 4) if isinstance(v, float) else v
                                for k, v in t.items()}), flush=True)
            del x, g
    torch.cuda.empty_cache()


def compare_step_grads(names, grads_k, grads_t, where: str,
                       scale_of=None) -> tuple:
    """A whole step's gradients through the kernels against the same step's
    through the twins: per tensor within TRAIN_GRAD_REL of its largest
    entry (or of ``scale_of(name)``, where given), plus 1e-6 of the largest
    gradient entry of all. Returns (worst share of a tensor's largest entry,
    its name)."""
    gmax = max(float(g.abs().max()) for g in grads_t if g is not None)
    worst, worst_name = 0.0, ""
    for name, a, b in zip(names, grads_k, grads_t):
        _check((a is None) == (b is None), f"{name}: gradient missing")
        if a is None:
            continue
        _check(bool(torch.isfinite(a).all()), f"{name}: gradient not finite")
        ref = float(b.abs().max())
        scale = (scale_of(name) if scale_of else None) or ref
        err = _max_err(a, b)
        _check(err <= TRAIN_GRAD_REL * scale + 1e-6 * gmax,
               f"{where}: {name} gradient max abs err {err} beside a "
               f"largest entry of {ref} (scale {scale})")
        if ref > 1e-3 * gmax and err / ref > worst:
            worst, worst_name = err / ref, name
    return worst, worst_name


def _train_config(root: str, name: str, **models) -> str:
    """The built-in stage-1 config, nothing of the model cut, with the
    cadences shortened (print every step, validate and save every
    TRAIN_EVERY) and ``models`` entries set; written under ``root``."""
    from havatar_tpu_torch.cli.common import resolve_config
    cfg = resolve_config(TRAIN_CONFIG)
    cfg.experiment.print_every = 1
    cfg.experiment.validate_every = TRAIN_EVERY
    cfg.experiment.save_every = TRAIN_EVERY
    for k, v in models.items():
        cfg.models[k] = v
    path = os.path.join(root, name)
    with open(path, "w") as f:
        f.write(cfg.dump())
    return path


def _one_step_kernels_vs_twins(dev, cfg, data: str) -> dict:
    """One stage-1 step's loss and gradients through the CUDA kernels
    against the same step through the plain twins: same seeded weights,
    batch and draws, and the kernel run's fine samples (the inverse CDF
    turns a rounding difference of a coarse weight into a jump of a sample).
    Returns what the kernel run's coarse call was given: (x, g, params)."""
    from havatar_tpu_torch.cli.common import to_device_batch
    from havatar_tpu_torch.cli.train_avatar import TRAIN_KEYS
    from havatar_tpu_torch.data import AvatarDataset, Loader
    from havatar_tpu_torch.models import nerf_field
    from havatar_tpu_torch.models import renderer as R
    from havatar_tpu_torch.ops import mlp as M
    from havatar_tpu_torch.train import stage1
    torch.manual_seed(11)
    ds = AvatarDataset(os.path.join(data, "sv_v31_all.json"), "train", cfg,
                       down_sample=cfg.dataset.down_sample)
    state = stage1.init_state(cfg, len(ds), dev)
    batch = next(iter(Loader(ds, batch_size=2, seed=3, num_workers=1)))
    batch = to_device_batch({k: batch[k] for k in TRAIN_KEYS}, dev)
    nerf = cfg.nerf.train
    B, Rn = batch["mv_rays"].shape[:2]
    noise = R.draw_render_noise(
        torch.Generator(device=dev).manual_seed(12), B, Rn, nerf.num_coarse,
        nerf.num_fine, bool(nerf.perturb),
        float(nerf.radiance_field_noise_std), dev)
    loss_fn = stage1.make_loss_fn(state.renderer, cfg)
    params = list(state.renderer.parameters()) + [state.latent_codes]
    names = [n for n, _ in state.renderer.named_parameters()] + [
        "latent_codes"]

    def step():
        for p in params:
            p.grad = None
        loss, _ = loss_fn(state.latent_codes, batch, noise)
        loss.backward()
        torch.cuda.synchronize()
        return float(loss.detach()), [None if p.grad is None else p.grad.clone()
                             for p in params]

    calls, samples = [], []
    real_op, real_pdf = nerf_field.fused_mlp_chain, R.sample_pdf

    def recording_op(x, *ps):
        call = {"x": x.detach(), "params": tuple(p.detach() for p in ps)}
        out = real_op(x, *ps)
        out.register_hook(lambda g: call.__setitem__("g", g.detach()))
        calls.append(call)
        return out

    def recording_pdf(*a, **kw):
        samples.append(real_pdf(*a, **kw))
        return samples[-1]

    n0 = M.mlp_forward.launches, M.mlp_backward.launches
    nerf_field.fused_mlp_chain = recording_op
    try:
        with deterministic_convs():
            with patched(sample_pdf=recording_pdf):
                loss_k, grads_k = step()
            n1 = M.mlp_forward.launches, M.mlp_backward.launches
            nerf_field.fused_mlp_chain = M.fused_mlp_chain_plain
            with patched(sample_pdf=lambda *a, **kw: samples[0]):
                loss_t, grads_t = step()
    finally:
        nerf_field.fused_mlp_chain = real_op
    _check((n1[0] - n0[0], n1[1] - n0[1]) == (2, 2)
           and (M.mlp_forward.launches, M.mlp_backward.launches) == n1,
           f"one step launched the dense-chain kernels {n0} -> {n1}, the "
           f"twins' step {n1} -> "
           f"{(M.mlp_forward.launches, M.mlp_backward.launches)}")
    rows = [c["x"].shape[0] for c in calls]
    _check(rows == [B * Rn * nerf.num_coarse, B * Rn * nerf.num_fine]
           and all("g" in c for c in calls),
           f"the step's dense-chain calls had {rows} rows")
    worst, worst_name = compare_step_grads(names, grads_k, grads_t,
                                           "one step, kernels vs twins")
    _check(abs(loss_k - loss_t) <= 1e-5 * abs(loss_t),
           f"one step, kernels vs twins: loss {loss_k} vs {loss_t}")
    print(f"[8 train] one step at full width, kernels vs twins on the same "
          f"draws and fine samples: loss {loss_k:.7f} vs {loss_t:.7f}; "
          f"{sum(g is not None for g in grads_k)} gradients, the worst "
          f"({worst_name}) off by {worst:.3g} of its largest entry (bound "
          f"{TRAIN_GRAD_REL})", flush=True)
    c = calls[0]
    return {"x": c["x"], "g": c["g"], "params": c["params"]}


class _TrainRun:
    """A stage-1 state on the seeded training set with its loader, warmed up
    by three steps: what the step timings below run on."""

    def __init__(self, dev, cfg, data: str):
        from havatar_tpu_torch.cli.train_avatar import TRAIN_KEYS
        from havatar_tpu_torch.data import (AvatarDataset, Loader,
                                            device_prefetch, infinite)
        from havatar_tpu_torch.train import stage1
        torch.manual_seed(13)
        ds = AvatarDataset(os.path.join(data, "sv_v31_all.json"), "train",
                           cfg, down_sample=cfg.dataset.down_sample)
        self.cfg = cfg
        self.state = stage1.init_state(cfg, len(ds), dev)
        self.batches = device_prefetch(
            infinite(Loader(ds, batch_size=2, seed=4)), size=2, device=dev,
            keys=TRAIN_KEYS)
        self.rng = torch.Generator(device=dev).manual_seed(14)
        self.loss_fn = stage1.make_loss_fn(self.state.renderer, cfg)
        self.train_step = stage1.make_train_step(self.state, cfg)
        for _ in range(3):
            self.step()
        torch.cuda.synchronize()

    def step(self, _i: int = 0) -> None:
        self.train_step(next(self.batches), self.rng)

    def ms_a_step(self, n: int = 10) -> float:
        """Host clock over ``n`` steps back to back, the device drained."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            self.step()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3


def _step_split(run: _TrainRun) -> None:
    """Steady-state training steps taken apart: the wait for a batch (host
    clock), then forward, backward and optimizer update as CUDA-event spans
    (the device's waits for the host's launches included), and the device's
    busy time in a torch.profiler trace of 5 steps."""
    from havatar_tpu_torch.train import stage1
    state, cfg = run.state, run.cfg

    def event():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    n, marks, waits = 10, [], []
    torch.cuda.synchronize()
    t_all = time.perf_counter()
    for _ in range(n):
        t0 = time.perf_counter()
        batch = next(run.batches)
        waits.append(time.perf_counter() - t0)
        m = [event()]
        state.optimizer.zero_grad(set_to_none=True)
        loss, _ = run.loss_fn(state.latent_codes, batch, run.rng)
        m.append(event())
        loss.backward()
        m.append(event())
        for group in state.optimizer.param_groups:
            group["lr"] = stage1.learning_rate(cfg, state.step)
        state.optimizer.step()
        state.step += 1
        m.append(event())
        marks.append(m)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t_all) / n * 1e3
    split = {"data_wait_host_ms": sum(waits) / n * 1e3}
    for i, k in enumerate(("forward", "backward", "optimizer")):
        split[f"{k}_ms"] = sum(m[i].elapsed_time(m[i + 1])
                               for m in marks) / n
    rays = batch["mv_rays"].shape
    print(f"[8 train] a step is {rays[0]} frames x {rays[1]} rays; "
          f"{step_ms:.2f} ms a step on the host clock ({n} steps back to "
          f"back, fused chain); split, mean of {n}: "
          + json.dumps({k: round(v, 4) for k, v in split.items()}),
          flush=True)
    profile_device(run.step, 5, step_ms, "8 train", "step")


def phase_train(dev, root: str) -> tuple:
    """Stage-1 training through the CLI at full width (see the module
    docstring, phase 8), in ``root``. Returns the dense-chain launch counts
    of the main run, of the bf16 run, the arguments of one step's coarse
    call, the training set's directory and the main run's last
    checkpoint."""
    from havatar_tpu_torch.cli import train_avatar as cli
    from havatar_tpu_torch.cli.common import resolve_config
    from havatar_tpu_torch.ops import mlp as M

    def counts():
        return {"mlp_fwd": M.mlp_forward.launches,
                "mlp_bwd": M.mlp_backward.launches}

    def reset():
        M.mlp_forward.launches = M.mlp_backward.launches = 0
        M.fused_mlp_chain.launches = 0

    t0 = time.perf_counter()
    data = os.path.join(root, "data")
    os.makedirs(data)
    _write_split(data, np.random.RandomState(8), TRAIN_FRAMES,
                 targets=True)
    fused = _train_config(root, "fused.yml", use_pallas_mlp=True)
    print(f"[8 train] wrote a training set of {TRAIN_FRAMES} frames x "
          f"{TRAIN_VIEWS} views (512^2 targets and masks) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # the main path: a fresh run, then a resumed one
    logs = os.path.join(root, "logs")
    reset()
    st = cli.main(["--datadir", data, "--logdir", logs, "--config", fused,
                   "--max-iters", str(TRAIN_STEPS), "--pretrain-iters",
                   str(TRAIN_PRETRAIN)])
    torch.cuda.synchronize()
    main_counts = counts()
    losses, bce = st["losses"], st["pretrain_bce"]
    n_val = (TRAIN_STEPS - 1) // TRAIN_EVERY
    # a 512^2 validation image goes through render_chunked in 16 chunks
    # of 16384 rays, each with a coarse and a fine forward launch
    val_launches = n_val * 2 * -(-SR_OUT * SR_OUT // 16384)
    print(f"[8 train] {st['step']} steps: loss {losses[0]:.5f} -> "
          f"{losses[-1]:.5f} (mean of the first 5 "
          f"{np.mean(losses[:5]):.5f}, of the last 5 "
          f"{np.mean(losses[-5:]):.5f}); pretraining BCE {bce[0]:.4f} -> "
          f"{bce[-1]:.4f} over {len(bce)} iterations; validation PSNR "
          f"{st['val_psnr']}; {st['s_per_iter']:.4f} s/iter (host clock, "
          f"device synchronized, mean of all steps); launches "
          f"{main_counts}, of which {val_launches} forward from "
          f"{n_val} validation renders", flush=True)
    _check(st["step"] == TRAIN_STEPS and len(losses) == TRAIN_STEPS
           and bool(np.isfinite(losses).all()), f"training: {st}")
    _check(np.mean(losses[-5:]) < np.mean(losses[:5]),
           "the loss did not fall")
    _check(len(bce) == TRAIN_PRETRAIN and bool(np.isfinite(bce).all())
           and np.mean(bce[-10:]) < np.mean(bce[:10]),
           "the pretraining's BCE did not fall")
    _check(main_counts == {"mlp_fwd": 2 * TRAIN_STEPS + val_launches,
                           "mlp_bwd": 2 * TRAIN_STEPS},
           f"dense-chain launches {main_counts} for {TRAIN_STEPS} steps "
           f"and {n_val} validation renders")
    _check(M.fused_mlp_chain.launches == sum(main_counts.values()),
           "fused_mlp_chain.launches is not the sum of its halves")
    _check(len(st["val_psnr"]) == n_val
           and bool(np.isfinite(st["val_psnr"]).all())
           and all(os.path.exists(os.path.join(
               logs, f"val_rgb_{i * TRAIN_EVERY:06d}.png"))
               for i in range(1, n_val + 1)),
           f"validation: {st['val_psnr']}, {sorted(os.listdir(logs))}")
    ckpt = os.path.join(st["checkpoint_dir"],
                        f"ckpt_{TRAIN_STEPS:08d}.pt")
    _check(os.path.exists(ckpt) and TRAIN_STEPS in st["saved_steps"],
           f"no checkpoint of step {TRAIN_STEPS}: {st['saved_steps']}")
    st2 = cli.main(["--datadir", data, "--logdir",
                    os.path.join(root, "logs_resumed"), "--config", fused,
                    "--max-iters", str(TRAIN_STEPS + 2), "--ckpt", ckpt])
    _check(st2["start_step"] == TRAIN_STEPS
           and st2["step"] == TRAIN_STEPS + 2
           and st2["pretrain_bce"] == []
           and bool(np.isfinite(st2["losses"]).all()),
           f"resumed run: {st2}")
    print(f"[8 train] resumed from {os.path.basename(ckpt)} "
          f"({os.path.getsize(ckpt) / 2**20:.1f} MiB) at step "
          f"{st2['start_step']}, two more steps: loss "
          f"{st2['losses']}", flush=True)

    captured = _one_step_kernels_vs_twins(dev, resolve_config(fused),
                                          data)

    # for the record: the same model in bf16 (the kernels' other type),
    # and in float32 without the fused chain
    reset()
    st_b = cli.main([
        "--datadir", data, "--logdir", os.path.join(root, "logs_bf16"),
        "--config", _train_config(root, "bf16.yml", use_pallas_mlp=True,
                                  compute_dtype="bfloat16"),
        "--max-iters", str(TRAIN_RECORD_STEPS), "--pretrain-iters", "0"])
    torch.cuda.synchronize()
    bf16_counts = counts()
    _check(bool(np.isfinite(st_b["losses"]).all())
           and bf16_counts == {"mlp_fwd": 2 * TRAIN_RECORD_STEPS,
                               "mlp_bwd": 2 * TRAIN_RECORD_STEPS},
           f"bf16 run: {st_b['losses']}, launches {bf16_counts}")
    reset()
    st_u = cli.main([
        "--datadir", data, "--logdir", os.path.join(root, "logs_plain"),
        "--config", _train_config(root, "plain.yml"),
        "--max-iters", str(TRAIN_RECORD_STEPS), "--pretrain-iters", "0"])
    torch.cuda.synchronize()
    _check(bool(np.isfinite(st_u["losses"]).all())
           and counts() == {"mlp_fwd": 0, "mlp_bwd": 0},
           f"unfused run: {st_u['losses']}, launches {counts()}")
    for what, s_ in (("bf16, fused chain", st_b),
                     ("float32, unfused chain", st_u)):
        print(f"[8 train] {what}, {TRAIN_RECORD_STEPS} steps from "
              f"scratch: loss {s_['losses'][0]:.5f} -> "
              f"{s_['losses'][-1]:.5f}, {s_['s_per_iter']:.4f} s/iter "
              f"(the first steps' warm-up included)", flush=True)
    print(f"[8 train] bf16 run's launches {bf16_counts}", flush=True)

    # the step with and without the fused chain, in turns on this card
    cfgs = {"fused": resolve_config(fused),
            "unfused": resolve_config(os.path.join(root, "plain.yml"))}
    turns = []
    for which in ("unfused", "fused", "fused", "unfused"):
        run = _TrainRun(dev, cfgs[which], data)
        turns.append((which, round(run.ms_a_step(), 2)))
        if len(turns) == 2:
            _step_split(run)
        del run
        torch.cuda.empty_cache()
    print(f"[8 train] ms a step on the host clock, 10 steps back to "
          f"back after 3 warm-up, a fresh state each turn: {turns}",
          flush=True)
    return main_counts, bf16_counts, captured, data, ckpt


# ---------------------------------------------------------------------------
# the quad field op (csrc/quad.cu) and stage-2 training
# ---------------------------------------------------------------------------

HD_CONFIG = "singleview_512_HD_base.yml"      # built into the port
HD_ITERS, HD_EVERY, HD_RECORD_ITERS = 10, 5, 3
# the NeRF's psnr over the run: the mean of the last three iterations may
# lie this far below the mean of the first three (draws move single
# iterations by about as much)
HD_PSNR_DROP_DB = 0.5
QUAD_NS = (262144, 100003)                    # seeded; plus a G step's call
QUAD_PLANE = 128                              # the production planes' side
QUAD_GRAD_NAMES = ("dplane_xy", "dplane_zy", "daux") + MLP_GRAD_NAMES[1:]


def quad_route(dtype, backward: bool) -> str:
    """The chain products' route of the quad kernels for planes in dtype:
    bf16 on the tensor cores; float32 forward on FFMA (csrc/ffma.cuh),
    float32 backward on csrc/chain_bwd.cuh's split TF32."""
    if dtype == torch.bfloat16:
        return "bf16"
    return "split" if backward else "ffma"


def quad_bound(planes, rows, aux, params, backward: bool, route: str = None):
    """Bound of a quad kernel from its call's arguments: the two planes,
    rows, aux, the parameters and the [N, 68] output move once (the
    backward reads as much cotangent and writes daux, the two float32
    plane gradients and the parameter gradients); the chain's products run
    at the rates of ``route`` (by default the kernel's own), the corner work
    (reduce; in the backward also its recompute, the splat and dw) in
    float32."""
    n = rows.shape[0]
    nbytes = _nbytes(*planes, rows, aux, *params) + n * 68 * 4
    if backward:
        nbytes += (n * 68 * 4 + _nbytes(aux) + 2 * planes[0].numel() * 4
                   + 4 * sum(p.numel() for p in params))
    tc, f32, split = chain_ops(
        n, backward, route or quad_route(planes[0].dtype, backward))
    f32 += 2.0 * n * 8 * C * (3 if backward else 1)
    return _bound_ms(nbytes, tc, f32, split)


def compare_quad_backward(got, want, dtype, where: str) -> dict:
    """(dplane_xy, dplane_zy, daux, grads) of the quad backward kernel
    against the twin's; one point in 10,000 may cross a kink (4 texels of
    each plane)."""
    k = max(1, got[2].shape[0] // 10000)
    return compare_backward(
        (*got[:3], *got[3]), (*want[:3], *want[3]), QUAD_GRAD_NAMES, dtype,
        where, per_row={"dplane_xy": 4 * k, "dplane_zy": 4 * k, "daux": k})


def _quad_inputs_seeded(gen, dev, n, dtype):
    """Two production-size planes, points over the box and a little past it
    (the zero padding's work), their cells and aux = posenc ++ corner
    weights, and a cotangent."""
    from havatar_tpu_torch.ops import mlp_quad as Q
    planes = [torch.randn(QUAD_PLANE, QUAD_PLANE, C, generator=gen).to(dev)
              .to(dtype) for _ in range(2)]
    warped = (torch.rand(n, 3, generator=gen) * 2.1 - 1.05).to(dev)
    rows, w8 = Q.quad_rows(warped, QUAD_PLANE, QUAD_PLANE)
    aux = torch.cat([(torch.rand(n, N_PE, generator=gen) * 2 - 1).to(dev),
                     w8], 1)
    g = torch.randn(n, 68, generator=gen).to(dev)
    return planes, rows, aux, g


def _check_quad(planes, rows, aux, g, params, where: str) -> tuple:
    """Both quad kernels against their twins on one call's arguments, and
    two backward launches' weight and bias gradients bit for bit."""
    from havatar_tpu_torch.ops import mlp_quad as Q
    dtype = planes[0].dtype
    with torch.no_grad():
        got = Q.quad_forward(*planes, rows, aux, *params)
        torch.cuda.synchronize()
        err_f = compare_mlp_forward(
            got, Q.field_radiance_quad_plain(*planes, rows, aux, *params),
            dtype, where)
        got_b = Q.quad_backward(*planes, rows, aux, g, *params)
        torch.cuda.synchronize()
        err_b = compare_quad_backward(
            got_b, Q.field_radiance_quad_bwd_plain(*planes, rows, aux, g,
                                                   *params), dtype, where)
        again = Q.quad_backward(*planes, rows, aux, g, *params)[3]
        _check(all(torch.equal(a, b) for a, b in zip(got_b[3], again)),
               f"{where}: two backward launches differ in a weight or bias "
               f"gradient")
    return err_f, err_b


def _unfused_field(call, g=None):
    """The field as it runs without a fused op, on the quad op's arguments:
    the bilinear gathers with their float32 corner sums, the interleaved
    plane features ++ posenc, five ``F.linear`` calls; with ``g`` also
    autograd's backward to the planes, points, posenc and parameters."""
    from havatar_tpu_torch.ops.grid_sample import sample_from_triplane
    from havatar_tpu_torch.scripts.micro_mlp import unfused_chain
    leaves = (call["plane_xy"], call["plane_zy"], call["warped"], call["pe"],
              *call["params"])
    if g is not None:
        leaves = [t.detach().requires_grad_() for t in leaves]
    pxy, pzy, warped, pe, *params = leaves
    feats = sample_from_triplane(warped[None],
                                 torch.stack([pxy, pzy])[:, None])[0]
    x = torch.cat([feats.reshape(feats.shape[0], -1), pe.to(feats.dtype)], -1)
    out = unfused_chain(x, params)
    if g is not None:
        return torch.autograd.grad(out, leaves, g)
    return out


def _quad_op(call, g=None):
    """The differentiable quad op on a call's arguments; with ``g`` also its
    backward to the planes, points, posenc and parameters."""
    from havatar_tpu_torch.ops import mlp_quad as Q
    leaves = (call["plane_xy"], call["plane_zy"], call["warped"], call["pe"],
              *call["params"])
    if g is not None:
        leaves = [t.detach().requires_grad_() for t in leaves]
    out = Q.field_radiance_quad(*leaves)
    if g is not None:
        return torch.autograd.grad(out, leaves, g)
    return out


def quad_timings(call, planes, rows, aux) -> dict:
    """CUDA-event times at one call's arguments: the two kernels and the old
    composition's gather and its regather with the splat of an [N, 8C]
    gradient (``scripts/micro_quad.py``'s timings), the twins, the unfused
    field and the whole op (forward, and forward with backward), and the
    bounds."""
    from havatar_tpu_torch.ops import mlp_quad as Q
    from havatar_tpu_torch.scripts import micro_quad
    g, params = call["g"], call["params"]
    with torch.no_grad():
        t = micro_quad.timings(planes, rows, aux, g, params, g.device)
        t.update({
            "fwd_plain_ms": _time_ms(
                lambda: Q.field_radiance_quad_plain(*planes, rows, aux,
                                                    *params), 2, 1),
            "bwd_plain_ms": _time_ms(
                lambda: Q.field_radiance_quad_bwd_plain(*planes, rows, aux,
                                                        g, *params), 2, 1),
            "unfused_fwd_ms": _time_ms(lambda: _unfused_field(call), 2, 1),
            "op_fwd_ms": _time_ms(lambda: _quad_op(call), 5)})
    t["unfused_fwd_bwd_ms"] = _time_ms(lambda: _unfused_field(call, g), 2, 1)
    t["op_fwd_bwd_ms"] = _time_ms(lambda: _quad_op(call, g), 5)
    (t["fwd_bound_ms"], t["fwd_bound_by"]) = quad_bound(planes, rows, aux,
                                                        params, False)
    (t["bwd_bound_ms"], t["bwd_bound_by"]) = quad_bound(planes, rows, aux,
                                                        params, True)
    if planes[0].dtype == torch.float32:
        t["fwd_bound_split_tf32_ms"] = quad_bound(
            planes, rows, aux, params, False, "split")[0]
        t["bwd_bound_ffma_ms"] = quad_bound(planes, rows, aux, params, True,
                                            "ffma")[0]
    return t


def _hd_config(root: str, name: str) -> str:
    """The built-in stage-2 config, nothing of the model cut, with
    ``models.use_pallas_mlp_quad`` on and the cadences shortened (print
    every iteration, a sample grid every HD_EVERY, save every HD_ITERS);
    written under ``root``."""
    from havatar_tpu_torch.cli.common import resolve_config
    cfg = resolve_config(HD_CONFIG)
    cfg.models.use_pallas_mlp_quad = True
    cfg.experiment.print_every = 1
    cfg.experiment.validate_every = HD_EVERY
    cfg.experiment.save_every = HD_ITERS
    path = os.path.join(root, name)
    with open(path, "w") as f:
        f.write(cfg.dump())
    return path


def _hd_state(dev, cfg, data: str, ckpt: str):
    """A stage-2 state restored from ``ckpt`` with optimizers that keep
    gradients and move nothing (SGD at rate 0), its steps, and one
    prepared batch on the card."""
    from havatar_tpu_torch.checkpoints.io import load_checkpoint
    from havatar_tpu_torch.checkpoints.stage2 import restore_stage2_training
    from havatar_tpu_torch.cli.common import BATCH_KEYS, to_device_batch
    from havatar_tpu_torch.cli.train_avatarHD import prepare_batch
    from havatar_tpu_torch.data import AvatarDataset, Loader
    from havatar_tpu_torch.train import stage2
    ds = AvatarDataset(os.path.join(data, "sv_v31_all.json"), "train", cfg,
                       down_sample=cfg.dataset.down_sample, full_image=True)
    state = stage2.init_state(cfg, len(ds), dev)
    restore_stage2_training(state, load_checkpoint(ckpt))
    state.nerf_opt = torch.optim.SGD(
        list(state.renderer.parameters()) + [state.latent_codes], lr=0.0)
    state.g_opt = torch.optim.SGD(state.generator.parameters(), lr=0.0)
    state.d_opt = torch.optim.SGD(state.discriminator.parameters(), lr=0.0)
    su = cfg.models.StyleUnet
    batch = next(iter(Loader(ds, batch_size=cfg.gan.batch, seed=3,
                             num_workers=1)))
    batch = to_device_batch(
        {k: v for k, v in prepare_batch(batch, su.out_size,
                                        su.inp_size).items()
         if k in BATCH_KEYS}, dev)
    return state, stage2.make_steps(state, cfg), batch


def _hd_step_kernels_vs_twins(dev, cfg, data: str, ckpt: str) -> dict:
    """One G step at full width through the quad kernels against the same
    step through their twins: the trained state, one batch, the same draws
    and the kernel run's fine samples. Returns the first op call's
    arguments (item 0's coarse pass) and its output cotangent."""
    from havatar_tpu_torch.models import nerf_field
    from havatar_tpu_torch.models import renderer as R
    from havatar_tpu_torch.ops import mlp_quad as Q
    from havatar_tpu_torch.train import stage2
    state, (_, _, g_step, _), batch = _hd_state(dev, cfg, data, ckpt)
    B, Rn = batch["mv_rays"].shape[:2]
    gen = torch.Generator(device=dev).manual_seed(21)
    nerf = cfg.nerf.train
    draws = stage2.Stage2Draws(
        R.draw_render_noise(gen, B, Rn, nerf.num_coarse, nerf.num_fine,
                            bool(nerf.perturb),
                            float(nerf.radiance_field_noise_std), dev),
        stage2.sample_styles(gen, state.generator, B, cfg.gan, dev))
    modules = {"renderer": state.renderer, "generator": state.generator}
    params = [(f"{k}.{n}", p) for k, m in modules.items()
              for n, p in m.named_parameters()]
    params.append(("latent_codes", state.latent_codes))

    def step():
        metrics = g_step(batch, draws)
        torch.cuda.synchronize()
        state.step = 0
        return metrics, [None if p.grad is None else p.grad.clone()
                         for _, p in params]

    calls, samples = [], []
    real_op, real_pdf = nerf_field.field_radiance_quad, R.sample_pdf
    real_fwd, real_bwd = Q.quad_forward, Q.quad_backward
    # each run's gradient of its first op call's two planes: what that
    # call's backward (kernel or twin) splatted
    dplanes, run = {}, ["kernels"]

    def recording_op(pxy, pzy, warped, pe, *ps, **kw):
        out = real_op(pxy, pzy, warped, pe, *ps, **kw)
        if run[0] not in dplanes:
            got = dplanes[run[0]] = [None, None]
            for i, t in enumerate((pxy, pzy)):
                t.register_hook(
                    lambda g, i=i: got.__setitem__(i, g.detach().clone()))
        if not calls:
            call = {"plane_xy": pxy.detach(), "plane_zy": pzy.detach(),
                    "warped": warped.detach(), "pe": pe.detach(),
                    "params": tuple(p.detach() for p in ps)}
            out.register_hook(lambda g: call.__setitem__("g", g.detach()))
            calls.append(call)
        return out

    def recording_pdf(*a, **kw):
        samples.append(real_pdf(*a, **kw))
        return samples[-1]

    def twin_fwd(pxy, pzy, rows, aux, *ps):
        with torch.no_grad():
            return Q.field_radiance_quad_plain(pxy, pzy, rows, aux, *ps)

    n0 = Q.quad_forward.launches, Q.quad_backward.launches
    nerf_field.field_radiance_quad = recording_op
    try:
        with deterministic_convs():
            with patched(sample_pdf=recording_pdf):
                m_k, grads_k = step()
            n1 = Q.quad_forward.launches, Q.quad_backward.launches
            Q.quad_forward, Q.quad_backward = (
                twin_fwd, Q.field_radiance_quad_bwd_plain)
            run[0] = "twins"
            replay = iter(samples)
            with patched(sample_pdf=lambda *a, **kw: next(replay)):
                m_t, grads_t = step()
    finally:
        nerf_field.field_radiance_quad = real_op
        Q.quad_forward, Q.quad_backward = real_fwd, real_bwd
    _check((n1[0] - n0[0], n1[1] - n0[1]) == (2 * B, 2 * B),
           f"one G step launched the quad kernels {n0} -> {n1}")
    _check("g" in calls[0] and calls[0]["warped"].shape[0]
           == Rn * nerf.num_coarse, f"the first op call: {calls[0].keys()}")
    # the generator sees the kernels only through the rendered features, and
    # some of its gradients are sums with heavy cancellation (a StyledConv's
    # scalar noise weight: noise times the gradient over 2 x 512^2 pixels),
    # so its tensors are held to the generator's largest gradient entry
    g_max = max(float(g.abs().max()) for (n, _), g in zip(params, grads_t)
                if n.startswith("generator.") and g is not None)
    worst, worst_name = compare_step_grads(
        [n for n, _ in params], grads_k, grads_t,
        "one G step, kernels vs twins",
        lambda n: g_max if n.startswith("generator.") else None)
    i_worst = [n for n, _ in params].index(worst_name)
    worst_abs = _max_err(grads_k[i_worst], grads_t[i_worst])
    worst_ref = float(grads_t[i_worst].abs().max())
    dp = [(_max_err(a, b), float(b.abs().max()))
          for a, b in zip(dplanes["kernels"], dplanes["twins"])]
    loss_k = float(m_k["nerf_loss"] + m_k["hr_l1"])
    loss_t = float(m_t["nerf_loss"] + m_t["hr_l1"])
    _check(abs(loss_k - loss_t) <= 1e-5 * abs(loss_t),
           f"one G step, kernels vs twins: loss {loss_k} vs {loss_t}")
    print(f"[9 hd] one G step at full width, kernels vs twins on the same "
          f"draws and fine samples: NeRF + L1 loss {loss_k:.7f} vs "
          f"{loss_t:.7f}, psnr {float(m_k['psnr']):.4f} vs "
          f"{float(m_t['psnr']):.4f}; launches {n0} -> {n1}; "
          f"{sum(g is not None for g in grads_k)} gradients, the worst "
          f"({worst_name}) off by {worst:.3g} of its largest entry (bound "
          f"{TRAIN_GRAD_REL}; the generator's of its largest entry of "
          f"{g_max:.4g}): {worst_abs:.4g} beside {worst_ref:.4g}; the first "
          f"op call's plane gradients (xy, zy) off by "
          f"{dp[0][0]:.4g} of {dp[0][1]:.4g} and {dp[1][0]:.4g} of "
          f"{dp[1][1]:.4g}", flush=True)
    return calls[0]


class _HDRun:
    """A fresh stage-2 state on the seeded set (random weights) with its
    loader, warmed up by two iterations: what the iteration timings below
    run on."""

    def __init__(self, dev, cfg, data: str):
        from havatar_tpu_torch.cli.common import BATCH_KEYS
        from havatar_tpu_torch.cli.train_avatarHD import prepare_batch
        from havatar_tpu_torch.data import (AvatarDataset, Loader,
                                            device_prefetch, infinite)
        from havatar_tpu_torch.train import stage2
        torch.manual_seed(23)
        ds = AvatarDataset(os.path.join(data, "sv_v31_all.json"), "train",
                           cfg, down_sample=cfg.dataset.down_sample,
                           full_image=True)
        su = cfg.models.StyleUnet
        self.state = stage2.init_state(cfg, len(ds), dev)
        self.d_step, self.r1_step, self.g_step, _ = stage2.make_steps(
            self.state, cfg)
        self.batches = device_prefetch(
            (prepare_batch(b, su.out_size, su.inp_size)
             for b in infinite(Loader(ds, batch_size=cfg.gan.batch, seed=4))),
            size=2, device=dev, keys=BATCH_KEYS)
        self.rng = torch.Generator(device=dev).manual_seed(24)
        for _ in range(2):
            self.iteration()
        torch.cuda.synchronize()

    def iteration(self, _i: int = 0) -> None:
        batch = next(self.batches)
        self.d_step(batch, self.rng)
        self.g_step(batch, self.rng)


def _hd_split(run: _HDRun) -> float:
    """Steady-state iterations (D step, G step; the R1 step runs one
    iteration in 16) taken apart: host clock over 5 iterations, the wait for
    a batch, the D and G steps as CUDA-event spans, one R1 step, the peak
    device memory, and the device's busy time in a torch.profiler trace of
    3 iterations. Returns ms an iteration."""
    def event():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    n, marks, waits = 5, [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_all = time.perf_counter()
    for _ in range(n):
        t0 = time.perf_counter()
        batch = next(run.batches)
        waits.append(time.perf_counter() - t0)
        m = [event()]
        run.d_step(batch, run.rng)
        m.append(event())
        run.g_step(batch, run.rng)
        m.append(event())
        marks.append(m)
    torch.cuda.synchronize()
    it_ms = (time.perf_counter() - t_all) / n * 1e3
    peak = torch.cuda.max_memory_allocated() / 2**30
    split = {"data_wait_host_ms": sum(waits) / n * 1e3,
             "d_step_ms": sum(m[0].elapsed_time(m[1]) for m in marks) / n,
             "g_step_ms": sum(m[1].elapsed_time(m[2]) for m in marks) / n}
    e0 = event()
    run.r1_step(batch)
    e1 = event()
    torch.cuda.synchronize()
    split["r1_step_ms"] = e0.elapsed_time(e1)
    print(f"[9 hd] {it_ms:.2f} ms an iteration (D step + G step) on the host "
          f"clock ({n} iterations back to back, quad op, float32); split, "
          f"mean of {n}: " + json.dumps({k: round(v, 4)
                                         for k, v in split.items()})
          + f"; peak device memory {peak:.2f} GiB "
          f"(torch.cuda.max_memory_allocated)", flush=True)
    profile_device(run.iteration, 3, it_ms, "9 hd", "iteration")
    return it_ms


def phase_hd(dev, root: str, data: str, stage1_ckpt: str) -> tuple:
    """Stage-2 training through the CLI at full width (see the module
    docstring, phase 9), in ``root``. Returns the quad kernels' launch
    counts of the main run and of the bf16 run, and the arguments of one G
    step's first op call."""
    from havatar_tpu_torch.cli import reenact as reenact_cli
    from havatar_tpu_torch.cli import train_avatarHD as cli
    from havatar_tpu_torch.cli.common import resolve_config
    from havatar_tpu_torch.data.image_io import imread_rgb
    from havatar_tpu_torch.ops import mlp_quad as Q

    # kernels 7 and 8 against their twins on seeded inputs
    gen = torch.Generator().manual_seed(15)
    params = _mlp_params(gen, dev)
    for dtype in (torch.float32, torch.bfloat16):
        for n in QUAD_NS:
            where = f"phase 9, {dtype}, N = {n}"
            planes, rows, aux, g = _quad_inputs_seeded(gen, dev, n, dtype)
            err_f, err_b = _check_quad(planes, rows, aux, g, params, where)
            print(f"[9 hd] quad kernels, {str(dtype).split('.')[-1]} N = {n}:"
                  f" forward max abs err {err_f:.3g}; backward "
                  + json.dumps({k: float(f"{v:.3g}")
                                for k, v in err_b.items()})
                  + "; weight gradients of two launches bit for bit",
                  flush=True)
    del planes, rows, aux, g
    torch.cuda.empty_cache()

    def counts():
        return {"quad_fwd": Q.quad_forward.launches,
                "quad_bwd": Q.quad_backward.launches}

    def reset():
        Q.quad_forward.launches = Q.quad_backward.launches = 0
        Q.field_radiance_quad.launches = 0

    config = _hd_config(root, "hd.yml")
    B = resolve_config(config).gan.batch
    logs = os.path.join(root, "logs_hd")
    reset()
    t0 = time.perf_counter()
    st = cli.main(["--datadir", data, "--logdir", logs, "--config", config,
                   "--ckpt", stage1_ckpt, "--max-iters", str(HD_ITERS)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    main_counts = counts()
    h = st["history"]
    grids = len(st["samples"])
    # a render is a coarse and a fine op call a batch item: the D step's
    # (no grad), the G step's (forward and backward), a sample grid's
    want = {"quad_fwd": HD_ITERS * 4 * B + grids * 2 * B,
            "quad_bwd": HD_ITERS * 2 * B}
    print(f"[9 hd] {st['iter']} iterations warm-started from "
          f"{os.path.basename(stage1_ckpt)} in {wall:.1f} s: psnr "
          f"{[round(v, 3) for v in h['psnr']]}, d "
          f"{[round(v, 4) for v in h['d']]}, g "
          f"{[round(v, 4) for v in h['g']]}, r1 {h['r1'][0]:.4g}; "
          f"{st['s_per_iter']:.4f} s/iter (CLI, host clock, device "
          f"synchronized); sample grids at {st['samples']}; launches "
          f"{main_counts}", flush=True)
    _check(st["iter"] == HD_ITERS and len(h["psnr"]) == HD_ITERS
           and all(bool(np.isfinite(h[k]).all()) for k in ("psnr", "d", "g"))
           and np.isfinite(h["r1"][0]), f"stage-2 training: {st}")
    _check(np.mean(h["psnr"][-3:]) >= np.mean(h["psnr"][:3]) - HD_PSNR_DROP_DB,
           f"the NeRF's psnr fell over the run: {h['psnr']}")
    _check(main_counts == want and Q.field_radiance_quad.launches
           == sum(main_counts.values()),
           f"quad launches {main_counts}, expected {want} for {HD_ITERS} "
           f"iterations and {grids} sample grids")
    _check(grids == (HD_ITERS - 1) // HD_EVERY and all(os.path.exists(
        os.path.join(logs, "sample", f"{i:06d}.png")) for i in st["samples"]),
        f"sample grids {st['samples']}")
    ckpt = os.path.join(st["checkpoint_dir"], f"ckpt_{HD_ITERS:08d}.pt")
    _check(os.path.exists(ckpt), f"no checkpoint: {st['saved']}")

    st2 = cli.main(["--datadir", data, "--logdir",
                    os.path.join(root, "logs_hd_resumed"), "--config",
                    config, "--ckpt", ckpt, "--continue-training",
                    "--max-iters", str(HD_ITERS + 2)])
    _check(st2["start"] == HD_ITERS and st2["iter"] == HD_ITERS + 2
           and bool(np.isfinite(st2["history"]["psnr"]).all()),
           f"resumed stage-2 run: {st2}")
    print(f"[9 hd] resumed from {os.path.basename(ckpt)} "
          f"({os.path.getsize(ckpt) / 2**20:.1f} MiB) at iteration "
          f"{st2['start']}: psnr {st2['history']['psnr']}", flush=True)

    # for the record: the fused D + G step, and --turbo (bf16 quads)
    runs = {}
    for what, flags in (("fast step", ["--fast-step"]),
                        ("turbo", ["--turbo"])):
        reset()
        s_ = cli.main(["--datadir", data, "--logdir",
                       os.path.join(root, f"logs_hd_{what[:4]}"), "--config",
                       config, "--ckpt", stage1_ckpt, "--max-iters",
                       str(HD_RECORD_ITERS)] + flags)
        torch.cuda.synchronize()
        runs[what] = counts()
        _check(bool(np.isfinite(s_["history"]["psnr"]).all())
               and runs[what] == {"quad_fwd": HD_RECORD_ITERS * 2 * B,
                                  "quad_bwd": HD_RECORD_ITERS * 2 * B},
               f"{what} run: {s_['history']}, launches {runs[what]}")
        print(f"[9 hd] {what}, {HD_RECORD_ITERS} iterations: psnr "
              f"{[round(v, 3) for v in s_['history']['psnr']]}, d "
              f"{[round(v, 4) for v in s_['history']['d']]}, "
              f"{s_['s_per_iter']:.4f} s/iter (warm-up included); launches "
              f"{runs[what]}", flush=True)

    cfg = resolve_config(config)
    captured = _hd_step_kernels_vs_twins(dev, cfg, data, ckpt)
    torch.cuda.empty_cache()
    run = _HDRun(dev, cfg, data)
    it_ms = _hd_split(run)
    del run
    torch.cuda.empty_cache()

    # train -> serve: the trained checkpoint through the reenactment CLI
    out = os.path.join(root, "served_hd")
    stats = reenact_cli.main(["--config", config, "--ckpt", ckpt, "--split",
                              os.path.join(data, "sv_v31_all.json"),
                              "--savedir", out, "--max-frames", "2"])
    names = sorted(os.listdir(os.path.join(out, "rgb")))
    _check(stats["frames"] == 2 and len(names) == 2 and all(
        imread_rgb(os.path.join(out, "rgb", k)).shape == (SR_OUT, SR_OUT, 3)
        for k in names), f"serving the stage-2 checkpoint: {stats}, {names}")
    print(f"[9 hd] served the trained checkpoint through cli/reenact.py: "
          f"{json.dumps(stats)}; {it_ms:.2f} ms a training iteration",
          flush=True)
    return main_counts, runs["turbo"], captured


def quad_kernel_rows(captured, main_counts, bf16_counts) -> list:
    """The four quad rows of the kernels line, on what a G step's first op
    call gave the op (item 0's coarse pass, 128^2 rays x 64 samples =
    1,048,576 rows; for the bf16 pair the same tensors with the planes in
    bf16). The ``launches`` of the float32 pair are the main stage-2 run's,
    of the bf16 pair the --turbo run's."""
    from havatar_tpu_torch.ops import mlp_quad as Q
    rows_out = []
    for dtype, launches in ((torch.float32, main_counts),
                            (torch.bfloat16, bf16_counts)):
        name = "f32" if dtype == torch.float32 else "bf16"
        call = dict(captured)
        call["plane_xy"] = captured["plane_xy"].to(dtype).contiguous()
        call["plane_zy"] = captured["plane_zy"].to(dtype).contiguous()
        planes = (call["plane_xy"], call["plane_zy"])
        H, W, _ = planes[0].shape
        rows, w8 = Q.quad_rows(call["warped"], H, W)
        aux = torch.cat([call["pe"].float(), w8], -1)
        g = call["g"].contiguous()
        err_f, err_b = _check_quad(planes, rows, aux, g, call["params"],
                                   f"phase 11, {dtype}, a G step's call")
        t = quad_timings(call, planes, rows, aux)
        common = {"route": "cuda",
                  "source": "havatar_tpu_torch/csrc/quad.cu",
                  "n_rows": rows.shape[0], "library_ms": None}
        extra = {d: {"products": quad_route(dtype, d == "bwd")}
                 for d in ("fwd", "bwd")}
        if dtype == torch.float32:
            extra["fwd"]["bound_split_tf32_ms"] = t["fwd_bound_split_tf32_ms"]
            extra["bwd"]["bound_ffma_ms"] = t["bwd_bound_ffma_ms"]
        rows_out.append({
            "name": f"mlp_quad_fwd_{name}", **common,
            "replaces": "havatar_tpu/ops/pallas_mlp_quad.py:186",
            "launches": launches["quad_fwd"], "max_abs_err": err_f,
            "ms": t["fwd_ms"], "plain_ms": t["fwd_plain_ms"],
            "bound_ms": t["fwd_bound_ms"], "bound_by": t["fwd_bound_by"],
            **extra["fwd"], "unfused_ms": t["unfused_fwd_ms"],
            "op_ms": t["op_fwd_ms"], "gather_ms": t["gather_ms"]})
        rows_out.append({
            "name": f"mlp_quad_bwd_{name}", **common,
            "replaces": "havatar_tpu/ops/pallas_mlp_quad.py:235",
            "body": "havatar_tpu_torch/csrc/chain_bwd.cuh",
            "launches": launches["quad_bwd"], **err_b,
            "ms": t["bwd_ms"], "plain_ms": t["bwd_plain_ms"],
            "bound_ms": t["bwd_bound_ms"], "bound_by": t["bwd_bound_by"],
            **extra["bwd"],
            "unfused_ms": t["unfused_fwd_bwd_ms"] - t["unfused_fwd_ms"],
            "op_ms": t["op_fwd_bwd_ms"] - t["op_fwd_ms"],
            "regather_splat_ms": t["regather_splat_ms"]})
        del rows, aux
        torch.cuda.empty_cache()
    return rows_out


def mlp_kernel_rows(captured, main_counts, bf16_counts) -> list:
    """The four dense-chain rows of the kernels line, on what a training
    step's coarse call gave the op (N = 2 x 4096 x 64 rows: with
    ``patch_rgb`` an item is one 64 x 64 patch; for the bf16 pair the same
    tensors in bf16). ``launches`` of the float32 pair is the
    main training run's count, of the bf16 pair the bf16 run's."""
    from havatar_tpu_torch.ops import mlp as M
    rows = []
    for dtype, launches in ((torch.float32, main_counts),
                            (torch.bfloat16, bf16_counts)):
        name = "f32" if dtype == torch.float32 else "bf16"
        x = captured["x"].to(dtype).contiguous()
        g, params = captured["g"].contiguous(), captured["params"]
        where = f"phase 11, {dtype}, a step's coarse call"
        with torch.no_grad():
            got = M.mlp_forward(x, *params)
            torch.cuda.synchronize()
            err_f = compare_mlp_forward(
                got, M.fused_mlp_chain_plain(x, *params), dtype, where)
            got_b = M.mlp_backward(x, g, *params)
            torch.cuda.synchronize()
            err_b = compare_mlp_backward(
                got_b, M.fused_mlp_chain_bwd_plain(x, g, *params), dtype,
                where)
        _grads_bit_identical(x, g, params, where)
        t = mlp_timings(x, g, params)
        common = {"route": "cuda", "products": mlp_route(dtype),
                  "n_rows": x.shape[0], "library_ms": None}
        ffma = {d: ({"bound_ffma_ms": t[f"{d}_bound_ffma_ms"]}
                    if dtype == torch.float32 else {}) for d in ("fwd", "bwd")}
        rows.append({
            "name": f"mlp_fwd_{name}", **common,
            "source": "havatar_tpu_torch/csrc/mlp.cu",
            "replaces": "havatar_tpu/ops/pallas_mlp.py:99",
            "launches": launches["mlp_fwd"], "max_abs_err": err_f,
            "ms": t["fwd_ms"], "plain_ms": t["fwd_plain_ms"],
            "bound_ms": t["fwd_bound_ms"], "bound_by": t["fwd_bound_by"],
            **ffma["fwd"], "unfused_ms": t["unfused_fwd_ms"]})
        rows.append({
            "name": f"mlp_bwd_{name}", **common,
            "source": "havatar_tpu_torch/csrc/mlp.cu",
            "body": "havatar_tpu_torch/csrc/chain_bwd.cuh",
            "replaces": "havatar_tpu/ops/pallas_mlp.py:231",
            "launches": launches["mlp_bwd"], **err_b,
            "ms": t["bwd_ms"], "plain_ms": t["bwd_plain_ms"],
            "bound_ms": t["bwd_bound_ms"], "bound_by": t["bwd_bound_by"],
            **ffma["bwd"], "unfused_ms": t["unfused_bwd_ms"],
            "grads_bit_identical": True})
    # the step's fine call has a quarter of the coarse call's rows; a
    # 1024-ray batch (patch_rgb off) would give a quarter of both
    n = captured["x"].shape[0]
    for rows_n, what in ((n // 4, "a step's fine call"),
                         (n // 16, "the fine call of a 2 x 1024-ray step")):
        t = mlp_timings(captured["x"][:rows_n].contiguous(),
                        captured["g"][:rows_n].contiguous(),
                        captured["params"])
        print(f"[11 kernels] float32, N = {rows_n} ({what}): "
              + json.dumps({k: round(v, 4) if isinstance(v, float) else v
                            for k, v in t.items()}), flush=True)
    return rows


# ---------------------------------------------------------------------------
# the field kernel (csrc/mlp.cu's field_eval_*), which no serving or
# training path runs
# ---------------------------------------------------------------------------

FIELD_NS = (1310720, 100003)   # the micro shape (16384 x (64 + 16)); ragged
FIELD_PTS_SPAN = 5.0           # |p| up to 5: top-frequency angles up to 640
FIELD_REPLACES = "havatar_tpu/ops/pallas_field.py:108"


def field_bound(pts, feat, params, route: str = None):
    """Bound of a field kernel from its call's arguments: the points, the
    features, the parameters and the [N, 68] float32 output move once; the
    chain's products run at the rates of ``route`` (by default the kernel's
    own: bf16 tensor cores, or FFMA for float32; posenc's 48 sines a row
    are not counted)."""
    n = pts.shape[0]
    return _bound_ms(_nbytes(pts, feat, *params) + n * 68 * 4,
                     *chain_ops(n, False, route or field_route(feat.dtype)))


def field_route(dtype) -> str:
    """The products' route of the field kernels for features in dtype."""
    return "bf16" if dtype == torch.bfloat16 else "ffma"


def phase_field(dev, golden) -> list:
    """Kernel 9: the count phases 4 to 9 left (0: no serving or training
    path runs it); the kernel against its twin on seeded inputs; on the
    golden scene's trained field (``golden``: phase 3's exact renderer's
    field and its coarse pass's points and planes) against the field's own
    float32 forward and, in bf16, the twin; the micro entry point. The
    golden and micro calls are the main path: their launches are counted.
    Returns the two rows of the kernels line, timed on the seeded inputs of
    the micro shape."""
    from havatar_tpu_torch.ops import field as FE
    from havatar_tpu_torch.scripts import micro_field
    _check(FE.fused_field_eval.launches == 0,
           f"phases 4 to 9 launched the field kernel "
           f"{FE.fused_field_eval.launches} times")
    f32, bf16 = torch.float32, torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(9)
    params = _mlp_params(torch.Generator().manual_seed(9), dev)
    errs, timed = {f32: 0.0, bf16: 0.0}, {}
    for n in FIELD_NS:
        pts = (torch.rand(n, 3, generator=gen, device=dev) * 2 - 1
               ) * FIELD_PTS_SPAN
        feat32 = torch.randn(n, FE.FEAT_IN, generator=gen, device=dev)
        line = []
        for dtype in (f32, bf16):
            feat = feat32.to(dtype)
            with torch.inference_mode():
                got = FE.fused_field_eval(pts, feat, *params)
                torch.cuda.synchronize()
                err = compare_mlp_forward(
                    got, FE.fused_field_eval_plain(pts, feat, *params), dtype,
                    f"phase 10, seeded, {dtype}, N = {n}")
            errs[dtype] = max(errs[dtype], err)
            line.append(f"{str(dtype).split('.')[-1]} {err:.3g}")
            if n == FIELD_NS[0]:
                timed[dtype] = (pts, feat)
        print(f"[10 field] seeded, N = {n}, |p| <= {FIELD_PTS_SPAN}: kernel "
              f"vs twin max abs err " + ", ".join(line), flush=True)

    # the main path: the trained field, then the micro entry point
    field, can, planes = golden
    launches = {}
    with torch.inference_mode():
        pts = can[0].contiguous()
        feat = field.sample_plane_features(can, planes)[0].contiguous()
        want = field(can, None, planes)[0]
        dense = field.dense_params()
        FE.fused_field_eval.launches = 0
        got = FE.fused_field_eval(pts, feat, *dense)
        torch.cuda.synchronize()
        launches[f32] = FE.fused_field_eval.launches
        feat16 = feat.to(bf16)
        FE.fused_field_eval.launches = 0
        got16 = FE.fused_field_eval(pts, feat16, *dense)
        torch.cuda.synchronize()
        launches[bf16] = FE.fused_field_eval.launches
        want16 = FE.fused_field_eval_plain(pts, feat16, *dense)
    _check(launches == {f32: 1, bf16: 1}, f"golden field: launches {launches}")
    err_g = compare_mlp_forward(got, want, f32,
                                "phase 10, golden, float32 vs field.forward")
    err_g16 = compare_mlp_forward(got16, want16, bf16,
                                  "phase 10, golden, bf16 vs twin")
    sigma = want[:, -1]
    print(f"[10 field] golden scene's trained field, exact renderer's coarse "
          f"pass ({pts.shape[0]} rows; sigma in [{float(sigma.min()):.3f}, "
          f"{float(sigma.max()):.3f}]): float32 kernel vs "
          f"field.forward max abs err {err_g:.3g}, bf16 kernel vs twin "
          f"{err_g16:.3g}; launches {launches[f32]} + {launches[bf16]}",
          flush=True)
    del feat, feat16, want, want16, got, got16, sigma

    FE.fused_field_eval.launches = 0
    res = micro_field.main(["--n", str(FIELD_NS[0])])
    _check(FE.fused_field_eval.launches == res["fused_calls"] > 0,
           f"micro_field: {FE.fused_field_eval.launches} launches for "
           f"{res['fused_calls']} calls")
    launches[bf16] += FE.fused_field_eval.launches
    print(f"[10 field] micro_field at N = {res['n']}: fused "
          f"{res['fused_bf16_ms']:.4f} ms, unfused "
          f"{res['unfused_bf16_ms']:.4f} ms (bf16), "
          f"{FE.fused_field_eval.launches} launches", flush=True)

    rows = []
    for dtype, name, err_gold in ((f32, "f32", err_g),
                                  (bf16, "bf16", err_g16)):
        pts, feat = timed[dtype]
        with torch.inference_mode():
            ms = _time_ms(lambda: FE.fused_field_eval(pts, feat, *params))
            plain_ms = _time_ms(
                lambda: FE.fused_field_eval_plain(pts, feat, *params), 5, 1)
            unfused_ms = _time_ms(lambda: micro_field.unfused_field_eval(
                pts, feat, *params), 5, 1)
        bound, by = field_bound(pts, feat, params)
        split = ({"bound_split_tf32_ms": field_bound(pts, feat, params,
                                                     "split")[0]}
                 if dtype == f32 else {})
        rows.append({
            "name": f"field_eval_{name}", "route": "cuda",
            "products": field_route(dtype), **split,
            "source": "havatar_tpu_torch/csrc/mlp.cu",
            "replaces": FIELD_REPLACES, "launches": launches[dtype],
            "n_rows": pts.shape[0], "max_abs_err": errs[dtype],
            "golden_max_abs_err": err_gold, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "unfused_ms": unfused_ms,
            "library_ms": None})
    del timed
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phase 12: monocular preprocessing (cli/fit_video.py) and the optional heads
# ---------------------------------------------------------------------------

FIT_RES, FIT_FRAMES = 512, 14                 # the CLI's default --tar_size
# a closed head of HEAD_LAT x HEAD_LON rings (about 20k vertices, the
# reference's FaceVerse mesh size, SURVEY section 4) and two eyeballs
HEAD_LAT, HEAD_LON, EYE_LAT, EYE_LON = 124, 156, 16, 20
FIT_LM_NOISE_PX = 0.5
FIT_LOSS_DROP = 10.0                          # frame 0's loss, first / last
RASTER_DEPTH_ATOL, RASTER_MASK_SHARE = 1e-4, 1e-3
FIT_LM_ATOL_PX, FIT_LOSS_RTOL = 0.1, 1e-3
FIT_PROFILE_ITERS = 20
SH_DEG, SH_N, SH_CHECK_N = 2, 16384 * 32, 4096
SH_TOL = dict(atol=1e-4, rtol=1e-3)
D_POSE_C_DIM = 25
D_TOL = dict(atol=1e-4, rtol=1e-3)
D_GRAD_REL = 1e-3                             # per tensor, of its largest entry
GS_TOL = dict(atol=1e-5, rtol=1e-4)


def _uv_sphere(n_lat: int, n_lon: int):
    """A closed UV sphere of radius 1: [V, 3] float64, [F, 3] int64."""
    th = np.pi * np.arange(1, n_lat) / n_lat
    ph = 2 * np.pi * np.arange(n_lon) / n_lon
    ring = np.stack([np.outer(np.sin(th), np.cos(ph)),
                     np.repeat(np.cos(th)[:, None], n_lon, 1),
                     np.outer(np.sin(th), np.sin(ph))], -1).reshape(-1, 3)
    verts = np.concatenate([[[0, 1, 0]], ring, [[0, -1, 0]]])
    last = len(verts) - 1
    k = np.arange(n_lon)
    r = lambda i, kk: 1 + (i - 1) * n_lon + kk % n_lon  # noqa: E731
    faces = [np.stack([np.zeros(n_lon, int), r(1, k), r(1, k + 1)], 1),
             np.stack([np.full(n_lon, last), r(n_lat - 1, k + 1),
                       r(n_lat - 1, k)], 1)]
    for i in range(1, n_lat - 1):
        a, b, c, d = r(i, k), r(i, k + 1), r(i + 1, k), r(i + 1, k + 1)
        faces += [np.stack([a, c, b], 1), np.stack([b, c, d], 1)]
    return verts, np.concatenate(faces).astype(np.int64)


def faceverse_dict(rng):
    """A seeded FaceVerse v3.1 dict at the reference's shapes: a closed
    head mesh of about 20k vertices whose last two vertex ranges are two
    eyeball spheres (``ver_inds``), smooth PCA bases (id 150, exp 171, tex
    251) and a 52-expression base, 478 MediaPipe keypoints (brows, chin
    and bridge where the crop reads them, 468:473 on the right eyeball,
    473:478 on the left), and ``point_buf`` with each vertex's faces,
    padded to the widest row by repeating the row's last face. Returns
    (dict, exBase_52 [3V, 52])."""
    head, head_f = _uv_sphere(HEAD_LAT, HEAD_LON)
    eye, eye_f = _uv_sphere(EYE_LAT, EYE_LON)
    head = head * [0.95, 1.15, 1.0] + [0.0, 0.0, -0.2]
    l_eye, r_eye = eye * 0.12 + [0.33, 0.2, 0.78], eye * 0.12 + [-0.33, 0.2, 0.78]
    v0, v1 = len(head), len(head) + len(eye)
    can = np.concatenate([head, l_eye, r_eye])           # canonical space
    tri = np.concatenate([head_f, eye_f + v0, eye_f + v1])
    V = len(can)

    def bases(k, amp):
        """k smooth deformation fields of the canonical vertices -> [3V, k]."""
        freq = rng.randn(3, k) * 1.5
        phase = rng.rand(k) * 2 * np.pi
        direc = rng.randn(3, k)
        field = np.sin(can @ freq + phase)[:, None, :] * direc[None]
        return (field * amp).reshape(3 * V, k)

    def to_raw(v):
        """Canonical -> the asset's raw units (load_model_dict's inverse:
        x 0.1, y/z flipped, y + 1)."""
        v = v.reshape(-1, 3).copy()
        v[:, 1] -= 1
        v = v / 0.1
        v[:, [1, 2]] *= -1
        return v

    def raw_base(b):
        b = b.reshape(V, 3, -1) / 0.1
        b[:, [1, 2]] *= -1
        return b.reshape(3 * V, -1).astype(np.float32)

    front = np.flatnonzero((np.arange(V) < v0) & (can[:, 2] > 0.2))
    kp = rng.choice(front, 478, replace=False)
    for slot, target in ((105, [0.3, 0.5, 0.7]), (334, [-0.3, 0.5, 0.7]),
                         (152, [0.0, -0.85, 0.45]), (6, [0.0, 0.3, 0.8])):
        kp[slot] = front[np.argmin(np.linalg.norm(can[front] - target, axis=1))]
    kp[468:473] = rng.choice(np.arange(v1, V), 5, replace=False)
    kp[473:478] = rng.choice(np.arange(v0, v1), 5, replace=False)

    adj = [[] for _ in range(V)]
    for f, (a, b, c) in enumerate(tri):
        adj[a].append(f), adj[b].append(f), adj[c].append(f)
    width = max(len(r) for r in adj)
    point_buf = np.asarray([r + [r[-1]] * (width - len(r)) for r in adj])
    md = {
        "meanshape": to_raw(can).reshape(-1).astype(np.float32),
        "meantex": (rng.rand(3 * V) * 150 + 60).astype(np.float32),
        "idBase": raw_base(bases(150, 0.02)),
        "exBase": raw_base(bases(171, 0.01)),
        "texBase": (bases(251, 2.0)).astype(np.float32),
        "tri": tri, "point_buf": point_buf.astype(np.int64),
        "mediapipe_keypoints": kp.astype(np.int64),
        "ver_inds": np.asarray([v0, v1, V]),
    }
    return md, raw_base(bases(52, 0.01))


def _gt_coeffs(rng, i: int, exp_dims: int, id_c):
    """Frame i's pose drifts (0.1 rad and 0.1 units over the video, from
    0.2 to 0.3 rad off the fit's start); the expression is new each
    frame."""
    from havatar_tpu_torch.preprocess import faceverse as FV
    c = np.zeros((1, FV.ID_DIMS + exp_dims + FV.TEX_DIMS + 38), np.float32)
    a = FV.ID_DIMS + exp_dims + FV.TEX_DIMS
    c[0, :FV.ID_DIMS] = id_c
    c[0, FV.ID_DIMS:FV.ID_DIMS + exp_dims] = np.abs(rng.randn(exp_dims)) * 0.3
    s = i / FIT_FRAMES
    c[0, a:a + 3] = [0.2 + 0.1 * s, -0.25 + 0.1 * s, 0.05]
    c[0, a + 30:a + 33] = [0.1 + 0.05 * s, -0.15 + 0.1 * s, 0.2]
    c[0, a + 33:a + 37] = rng.randn(4) * 0.05
    c[0, -1] = 1.0
    return c


def write_fit_inputs(root: str, seed: int = 12) -> dict:
    """Write the fit's inputs under ``root``: the FaceVerse files, a
    ``FIT_RES``^2 MJPG video of ``FIT_FRAMES`` frames, each frame's
    landmarks (the seeded model's projection at a drifting pose, plus
    noise) and its mask. Returns the paths and the ground truth."""
    import cv2
    from havatar_tpu_torch.preprocess import faceverse as FV
    rng = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    md, exp52 = faceverse_dict(rng)
    fv_path, exp52_path = (os.path.join(root, "faceverse_v3_1.npy"),
                           os.path.join(root, "exBase_52.npy"))
    np.save(fv_path, md, allow_pickle=True)
    np.save(exp52_path, exp52)
    model = FV.load_model_dict(md, exp52, device="cpu")
    intr = (1315.0, 1315.0, FIT_RES / 2, FIT_RES / 2)
    id_c = rng.randn(FV.ID_DIMS) * 0.2
    lms_dir = os.path.join(root, "lms")
    base = os.path.join(root, "out")
    mask_dir = os.path.join(base, f"mv_mask{FIT_RES}", "0")
    os.makedirs(lms_dir)
    os.makedirs(mask_dir)
    video = os.path.join(root, "input.avi")
    vw = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"MJPG"), 25,
                         (FIT_RES, FIT_RES))
    _check(vw.isOpened(), "phase 12: OpenCV's MJPG video writer did not open")
    yy, xx = np.mgrid[:FIT_RES, :FIT_RES]
    gts = []
    for i in range(FIT_FRAMES):
        c = _gt_coeffs(rng, i, model.exp_dims, id_c)
        lms, _ = FV.forward_landmarks(model, torch.from_numpy(c), *intr)
        lms = lms[0].numpy() + rng.randn(478, 2) * FIT_LM_NOISE_PX
        np.save(os.path.join(lms_dir, f"{i}.npy"), lms.astype(np.float32))
        gts.append(c)
        cx, cy = lms[:, 0].mean(), lms[:, 1].mean()
        inside = ((xx - cx) / 150) ** 2 + ((yy - cy) / 190) ** 2 < 1
        frame = (rng.rand(FIT_RES, FIT_RES, 3) * 40).astype(np.uint8)
        frame[inside] = (180, 160, 140)
        vw.write(frame)
        cv2.imwrite(os.path.join(mask_dir, f"{i}.png"),
                    inside.astype(np.uint8) * 255)
    vw.release()
    _check(os.path.getsize(video) > 0, "phase 12: the video is empty")
    return dict(fv_path=fv_path, exp52_path=exp52_path, lms_dir=lms_dir,
                base=base, video=video, gts=gts, model_dict=md, exp52=exp52,
                intr=intr)


def _fit_state(coeffs, exp_dims, dev):
    from havatar_tpu_torch.preprocess import faceverse as FV
    from havatar_tpu_torch.preprocess import fitting as FIT
    parts = FV.split_coeffs(torch.from_numpy(coeffs[None]).to(dev), exp_dims)
    return FIT.FitState(*(p.clone() for p in parts))


def _fit_on(dev, inp, model, frame: int, iters: int, prev_coeffs):
    """A later frame's fit (``fit_rest``'s settings) from the previous
    frame's coefficients; returns (projected landmarks [478, 2], losses,
    host seconds)."""
    from havatar_tpu_torch.preprocess import faceverse as FV
    from havatar_tpu_torch.preprocess import fitting as FIT
    fit = FIT.make_fit_frame(model, inp["intr"], FIT.FitConfig(), iters,
                             first_frame=False, fit_id=False)
    state = _fit_state(prev_coeffs, model.exp_dims, dev)
    gt = torch.from_numpy(np.load(os.path.join(inp["lms_dir"],
                                               f"{frame}.npy"))).to(dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    state2, losses = fit(state, gt, state.rot, state.trans)
    lms, _ = FV.forward_landmarks(model, FIT.pack(state2), *inp["intr"])
    lms, losses = lms[0].cpu(), losses.cpu()
    return lms, losses, time.perf_counter() - t0


def _check_splits_and_renders(inp, out) -> None:
    import cv2
    from havatar_tpu_torch.data.dataset import AvatarDataset
    from havatar_tpu_torch.utils.cfgnode import CfgNode
    _check(out["frames"] == [str(i) for i in range(FIT_FRAMES)],
           f"phase 12: fitted frames {out['frames']}")
    drop = out["first_loss"]["0"] / out["last_loss"]["0"]
    print(f"[12 preprocess] frame 0: loss {out['first_loss']['0']:.6g} -> "
          f"{out['last_loss']['0']:.6g} ({drop:.1f}x); frame 13: "
          f"{out['first_loss']['13']:.6g} -> {out['last_loss']['13']:.6g}",
          flush=True)
    _check(drop >= FIT_LOSS_DROP,
           f"phase 12: frame 0's loss fell only {drop:.2f}x")
    save = os.path.join(inp["base"], "tracking")
    for f in out["frames"]:
        for view in ("front", "left", "right"):
            img = cv2.imread(os.path.join(
                save, f, f"ortho_{view}_render_256_baseGama.png"))
            nrm = cv2.imread(os.path.join(
                save, f, f"ortho_{view}_normal_256_baseGama.png"))
            _check(img is not None and nrm is not None,
                   f"phase 12: frame {f} lacks its {view} render")
            _check((img > 0).any(-1).mean() > 0.05 and (nrm > 0).any(),
                   f"phase 12: frame {f}'s {view} render is blank")
    split = json.loads(open(out["split"]).read())
    fidx = sorted(fr["fidx"] for fr in split["frames"])
    _check(fidx == list(range(10, FIT_FRAMES)),
           f"phase 12: the split holds frames {fidx}")
    cfg = CfgNode({"experiment": {"patch_rgb": False},
                   "dataset": {"near": -1.6, "far": 1.0, "length": 1.0,
                               "num_random_rays": 1024,
                               "cond_render_res": 256}})
    item = AvatarDataset(out["split"], "train", cfg).load_item(0)
    _check(item["mv_rays"].shape == (1024, 12)
           and bool(np.isfinite(item["mv_rays"]).all()),
           "phase 12: the split's item has no finite rays")
    print(f"[12 preprocess] split {os.path.basename(out['split'])}: frames "
          f"{fidx}; an item loads through AvatarDataset "
          f"(mv_rays {tuple(item['mv_rays'].shape)}, finite)", flush=True)


def _check_raster_and_fit(dev, inp, out) -> None:
    """Frame 0's front-view rasterization and a 100-iteration fit of frame
    11 (from frame 10's coefficients): on the card against the CPU."""
    from havatar_tpu_torch.ops.boxwarp import BoxWarp
    from havatar_tpu_torch.preprocess import faceverse as FV
    from havatar_tpu_torch.preprocess import pipeline as P
    from havatar_tpu_torch.preprocess.rasterizer import (
        DEFAULT_CHUNK, chunk_peak_bytes, rasterize_ortho,
        render_ortho_condition)
    save = os.path.join(inp["base"], "tracking")
    res = []
    for d in (dev, torch.device("cpu")):
        model = FV.load_model_dict(inp["model_dict"], inp["exp52"], device=d)
        c = np.load(os.path.join(save, "0", "coeffs.npy"))
        id_c, exp_c, tex_c, _, _, _, eye_c, _ = FV.split_coeffs(
            torch.from_numpy(c[None]).to(d), model.exp_dims)
        verts = BoxWarp.from_bounds(P.CANONICAL_BOUNDS)(
            FV.get_vs(model, id_c, exp_c, eye_c)[0])
        colors = FV.get_color(model, tex_c)[0]
        rot = P.ortho_view_rotations(d)["front"]
        img, depth, mask = rasterize_ortho(verts @ rot, model.tri, colors,
                                           P.ORTHO_K, 256)
        c10 = np.load(os.path.join(save, "10", "coeffs.npy"))
        lms, losses, secs = _fit_on(d, inp, model, 11, 100, c10)
        res.append((depth.cpu(), mask.cpu(), img.cpu(), lms, losses, secs))
        if len(res) == 1:
            ms = _time_ms(lambda: render_ortho_condition(
                verts, model.tri, colors, rot, P.ORTHO_K, 256), iters=5,
                warmup=1)
            print(f"[12 preprocess] rasterizer: {ms:.3f} ms a 256^2 view on "
                  f"the card ({model.tri.shape[0]} faces, {model.num_vertex} "
                  f"vertices, chunk {DEFAULT_CHUNK}: "
                  f"{chunk_peak_bytes(256, DEFAULT_CHUNK) / 2 ** 30:.2f} GiB "
                  f"working set)", flush=True)
            _time_raster_windows(verts @ rot, model.tri, colors)
    (dg, mg, ig, lg, sg, tg), (dc, mc, ic, lc, sc, tc) = res
    both = mg & mc
    differ = float((mg != mc).float().mean())
    derr = float((dg[both] - dc[both]).abs().max())
    print(f"[12 preprocess] frame 0 front view, card vs CPU: {int(mg.sum())} "
          f"hit pixels, masks differ on {differ:.2e} of pixels, depth max err "
          f"{derr:.3e}, colour max err "
          f"{float((ig[both] - ic[both]).abs().max()):.3e}", flush=True)
    _check(differ <= RASTER_MASK_SHARE and derr <= RASTER_DEPTH_ATOL,
           "phase 12: the card's rasterization is not the CPU's")
    lerr = float((lg - lc).abs().max())
    lrel = abs(float(sg[-1]) - float(sc[-1])) / abs(float(sc[-1]))
    print(f"[12 preprocess] frame 11's 100-iteration fit, card vs CPU: "
          f"landmarks max err {lerr:.4f} px, loss {float(sg[-1]):.6g} vs "
          f"{float(sc[-1]):.6g} (rel {lrel:.2e}); {tg:.2f} s on the card, "
          f"{tc:.2f} s on the CPU", flush=True)
    _check(lerr <= FIT_LM_ATOL_PX and lrel <= FIT_LOSS_RTOL,
           "phase 12: the card's fit is not the CPU's")


def _time_raster_windows(verts, tri, colors) -> None:
    """``rasterize_ortho`` with its chunk windows against the dense form
    JAX takes (every chunk's window the whole image), on the card: on the
    head's own face order (built ring by ring, so a chunk is a thin band,
    the windows' best case) and on the same faces in a seeded random order
    (a chunk's window near the head's whole box). Both forms must give the
    same image, depth and hit mask."""
    from unittest import mock
    from havatar_tpu_torch.preprocess import pipeline as P
    from havatar_tpu_torch.preprocess import rasterizer as R

    def dense(x_ndc, y_ndc, faces, chunk, res):
        return [(0, res - 1, 0, res - 1)] * -(-faces.shape[0] // chunk)

    perm = torch.randperm(tri.shape[0],
                          generator=torch.Generator().manual_seed(24))
    line = []
    shuffled = tri[perm.to(tri.device)]
    for order, faces in (("ring", tri), ("shuffled", shuffled)):
        def run():
            return R.rasterize_ortho(verts, faces, colors, P.ORTHO_K, 256)
        win = run()
        ms_win = _time_ms(run, iters=5, warmup=1)
        with mock.patch.object(R, "_chunk_windows", dense):
            full = run()
            ms_dense = _time_ms(run, iters=5, warmup=1)
        err = max(float((a.float() - b.float()).abs().max())
                  for a, b in zip(win, full))
        line.append(f"{order} order: windows {ms_win:.3f} ms, dense "
                    f"{ms_dense:.3f} ms, max diff {err:.3e}")
        _check(all(torch.equal(a, b) for a, b in zip(win, full)),
               f"phase 12: the chunk windows change the {order}-order view")
    print("[12 preprocess] rasterizer a 256^2 view, chunk windows vs dense "
          "(CUDA events, 5 views): " + "; ".join(line), flush=True)


def _profile_fit(dev, inp) -> None:
    """Launches, device busy time and host time an iteration of a later
    frame's fit (torch.profiler, ``FIT_PROFILE_ITERS`` iterations)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from havatar_tpu_torch.preprocess import faceverse as FV
    model = FV.load_model_dict(inp["model_dict"], inp["exp52"], device=dev)
    c10 = np.load(os.path.join(inp["base"], "tracking", "10", "coeffs.npy"))
    _, _, secs = _fit_on(dev, inp, model, 11, FIT_PROFILE_ITERS, c10)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _fit_on(dev, inp, model, 11, FIT_PROFILE_ITERS, c10)
        torch.cuda.synchronize()
    on_dev = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    n = FIT_PROFILE_ITERS
    launches = sum(e.count for e in on_dev) / n
    busy = sum(e.self_device_time_total for e in on_dev) / 1e3 / n
    host = secs * 1e3 / n
    print(f"[12 preprocess] fit: {launches:.1f} device launches an iteration, "
          f"device busy {busy:.4f} ms of {host:.4f} ms an iteration on the "
          f"host clock (idle share {1 - busy / host:.4f}; torch.profiler, "
          f"{n} iterations)", flush=True)


def _check_heads(dev) -> None:
    """The field's SH head at the flagship width, the discriminator's pose
    head at 512^2 and 2D border padding: on the card against the CPU (or
    F.grid_sample), TF32 off."""
    import torch.nn.functional as F
    from havatar_tpu_torch.infer.reenact import seeded_init_
    from havatar_tpu_torch.models.discriminator import WaveletDiscriminator
    from havatar_tpu_torch.models.nerf_field import DoublePlaneNeRFField
    from havatar_tpu_torch.ops.grid_sample import grid_sample_2d
    gen = torch.Generator().manual_seed(21)

    def grads(m):
        return {n: p.grad.detach().cpu() for n, p in m.named_parameters()
                if p.grad is not None}

    field = seeded_init_(DoublePlaneNeRFField(sh_deg=SH_DEG), seed=21)
    planes = torch.randn(2, 1, 128, 128, 64, generator=gen) * 0.5
    pts = (torch.rand(1, SH_N, 3, generator=gen) * 3 - 1.5)
    dirs = F.normalize(torch.randn(1, SH_N, 3, generator=gen), dim=-1)
    cot = torch.randn(1, SH_N, 3 + 64 + 1, generator=gen)
    field_d = DoublePlaneNeRFField(sh_deg=SH_DEG).to(dev)
    field_d.load_state_dict(field.state_dict())
    out = field_d(pts.to(dev), dirs.to(dev), planes.to(dev))
    (out * cot.to(dev)).sum().backward()
    _check(bool(torch.isfinite(out).all()), "phase 12: SH head not finite")
    field_d.zero_grad()
    k = SH_CHECK_N
    got = field_d(pts[:, :k].to(dev), dirs[:, :k].to(dev), planes.to(dev))
    (got * cot[:, :k].to(dev)).sum().backward()
    want = field(pts[:, :k], dirs[:, :k], planes)
    (want * cot[:, :k]).sum().backward()
    fwd_err = float((got.detach().cpu() - want.detach()).abs().max())
    _check(torch.allclose(got.detach().cpu(), want.detach(), **SH_TOL),
           f"phase 12: SH head forward, card vs CPU, max err {fwd_err:.3e}")
    gw, gg = grads(field), grads(field_d)
    gerr = max(float((gg[n] - w).abs().max()) for n, w in gw.items())
    _check(set(gw) == set(gg) and all(
        torch.allclose(gg[n], w, **SH_TOL) for n, w in gw.items()),
        f"phase 12: SH head gradients, card vs CPU, max err {gerr:.3e}")
    print(f"[12 heads] field sh_deg {SH_DEG} (fc_rgb "
          f"{tuple(field.fc_rgb.weight.shape)}): forward and backward on "
          f"{SH_N} points on the card; first {k}: forward max err "
          f"{fwd_err:.3e}, gradients max err {gerr:.3e} against the CPU",
          flush=True)

    disc = seeded_init_(WaveletDiscriminator(size=512, c_dim=D_POSE_C_DIM),
                        seed=22)
    disc_d = WaveletDiscriminator(size=512, c_dim=D_POSE_C_DIM).to(dev)
    disc_d.load_state_dict(disc.state_dict())
    img = torch.rand(2, 3, 512, 512, generator=gen) * 2 - 1
    pose = torch.randn(2, D_POSE_C_DIM, generator=gen)
    s2 = disc_d(img.to(dev), pose.to(dev))
    s2.sum().backward()
    _check(s2.shape == (2, 1) and bool(torch.isfinite(s2).all()),
           "phase 12: the pose head's batch-2 scores")
    disc_d.zero_grad()
    with deterministic_convs():
        got = disc_d(img[:1].to(dev), pose[:1].to(dev))
        got.sum().backward()
    want = disc(img[:1], pose[:1])
    want.sum().backward()
    gw, gg = grads(disc), grads(disc_d)
    worst = max(float((gg[n] - w).abs().max()) / max(float(w.abs().max()),
                                                     1e-12)
                for n, w in gw.items())
    print(f"[12 heads] discriminator 512^2 c_dim {D_POSE_C_DIM}: batch 2 "
          f"forward and backward on the card; batch 1 score "
          f"{float(got.detach()):.6g} vs {float(want.detach()):.6g} on the CPU, gradients "
          f"worst {worst:.3e} of their tensor's largest entry", flush=True)
    _check(torch.allclose(got.detach().cpu(), want.detach(), **D_TOL)
           and set(gw) == set(gg) and worst <= D_GRAD_REL,
           "phase 12: the pose head, card vs CPU")

    g = torch.Generator(device=dev).manual_seed(23)
    feat = torch.randn(2, 128, 128, 64, generator=g, device=dev)
    coords = torch.rand(2, 65536, 2, generator=g, device=dev) * 2.6 - 1.3
    got = grid_sample_2d(feat, coords, "border")
    want = F.grid_sample(feat.permute(0, 3, 1, 2), coords[:, :, None],
                         padding_mode="border", align_corners=True
                         )[..., 0].permute(0, 2, 1)
    err = float((got - want).abs().max())
    print(f"[12 heads] grid_sample_2d border against F.grid_sample on the "
          f"card: max err {err:.3e}", flush=True)
    _check(torch.allclose(got, want, **GS_TOL),
           "phase 12: border padding against F.grid_sample")


def phase_preprocess(dev, root: str) -> dict:
    """Phase 12: the seeded inputs, then ``cli/fit_video.py`` at its
    defaults on the card; its outputs, the rasterizer and a fit against
    the CPU; the fit's launches an iteration; then the optional heads. The
    inputs are written under ``root``; returns them (phase 13 reads them)."""
    from havatar_tpu_torch.cli import fit_video
    t0 = time.perf_counter()
    inp = write_fit_inputs(root)
    md = inp["model_dict"]
    print(f"[12 preprocess] inputs in {time.perf_counter() - t0:.1f} s: "
          f"FaceVerse dict V = {len(md['meanshape']) // 3}, F = "
          f"{len(md['tri'])}, point_buf {md['point_buf'].shape}, "
          f"ver_inds {md['ver_inds'].tolist()}; a {FIT_RES}^2 MJPG video "
          f"of {FIT_FRAMES} frames", flush=True)
    live = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fit_video.main([
        "--video_path", inp["video"], "--base_dir", inp["base"],
        "--faceverse_path", inp["fv_path"],
        "--exp52_path", inp["exp52_path"], "--lms_dir", inp["lms_dir"]])
    wall = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() - live) / 2 ** 30
    later = [out["fit_s"][f] for f in out["frames"][1:]]
    renders = list(out["render_s"].values())
    print(f"[12 preprocess] cli/fit_video.py at its defaults "
          f"({FIT_RES}^2, 2000 + 100 iterations): {wall:.2f} s; fit "
          f"frame 0 {out['fit_s']['0']:.3f} s, a later frame "
          f"{np.median(later):.3f} s (median; {min(later):.3f} to "
          f"{max(later):.3f}); three renders a frame {np.median(renders):.3f}"
          f" s (median); peak device memory {peak:.3f} GiB above the "
          f"{live / 2 ** 30:.3f} GiB live before it", flush=True)
    _check_splits_and_renders(inp, out)
    _check_raster_and_fit(dev, inp, out)
    _profile_fit(dev, inp)
    _check_heads(dev)
    return inp


# ---------------------------------------------------------------------------
# phase 13: the preprocessing networks (preprocess/landmark_net.py,
# tracker.py, retinaface.py, rvm.py, onnx_rt.py) and cli/fit_video.py's
# network flags
# ---------------------------------------------------------------------------

# card against CPU, TF32 off. The conv nets start from JAX's own test
# bounds (torch against JAX, both on a CPU): cuDNN's float32 algorithms sum
# in other orders than the CPU's, through 20 to 60 layers.
NET_TOL = dict(atol=2e-5, rtol=1e-4)          # landmark, detection, gaze
RF_LOC_TOL = dict(atol=2e-4, rtol=1e-3)       # RetinaFace's box regression
RF_CONF_TOL = dict(atol=1e-5, rtol=1e-4)      # its softmaxed scores
RVM_FULL_ATOL = 2e-4                          # full resolution
RVM_REFINED_ATOL = 5e-4                       # through the refiner, and
                                              # the carried states
# decoded landmarks, in pixels: the offsets' logit multiplies a map's error
# by 1 / (p (1 - p)) x 223 / 16 x the crop scale
LM_PX_ATOL = 1e-2
ONNX_TOL = dict(atol=1e-4, rtol=1e-4)         # the hand-built graph
RVM_RATIO = 0.25                              # the CLI's downsample ratio
RVM_SEED = 63
NET_BATCHES = (1, 4)                          # landmark crops a call
NET_FIT_FLAGS = ["--first_frame_iters", "100", "--frame_iters", "20"]


def _on(net, dev):
    """A copy of a CPU module on ``dev``."""
    import copy
    return copy.deepcopy(net).to(dev).eval()


def _close(got, want, tol: dict, where: str) -> float:
    got, want = got.float().cpu(), want.float().cpu()
    err = float((got - want).abs().max())
    _check(bool(torch.isfinite(got).all()), f"phase 13: {where} not finite")
    _check(torch.allclose(got, want, **tol),
           f"phase 13: {where}, card vs CPU, max err {err:.3e} (bound {tol})")
    return err


def _check_nets(dev) -> dict:
    """The OpenSeeFace nets and RetinaFace at full width on seeded weights,
    card against CPU; ms a call (CUDA events)."""
    from havatar_tpu_torch.preprocess import landmark_net as L
    from havatar_tpu_torch.preprocess.nets import seed_
    from havatar_tpu_torch.preprocess.retinaface import RetinaFace
    rng = np.random.RandomState(31)
    cpu = torch.device("cpu")
    res: dict = {"ms": {}, "err": {}}
    with torch.inference_mode():
        for mt in range(4):
            net = L.seeded_net("landmark", 40 + mt, mt, confident=True)
            x = torch.from_numpy(rng.randn(4, 3, 224, 224).astype(np.float32))
            want, g, xd = net(x), _on(net, dev), x.to(dev)
            got = g(xd)
            res["err"][f"landmark{mt}"] = _close(
                got, want, NET_TOL, f"landmark net {mt}, 4 crops")
            px = 0.0
            for i in range(4):
                lg = L.decode_landmarks(L.nhwc(got[i:i + 1])[0])[1]
                lw = L.decode_landmarks(L.nhwc(want[i:i + 1])[0])[1]
                px = max(px, float(np.abs(lg - lw).max()))
            _check(px <= LM_PX_ATOL, f"phase 13: landmark net {mt}'s decoded "
                   f"landmarks, card vs CPU, {px:.3e} px")
            res["err"][f"landmark{mt}_px"] = px
            for b in NET_BATCHES:
                res["ms"][f"landmark{mt}_b{b}"] = _time_ms(lambda: g(xd[:b]))
        for kind, shape in (("detection", (1, 3, 224, 224)),
                            ("gaze", (2, 3, 32, 32))):
            net = L.seeded_net(kind, 50, confident=kind == "detection")
            x = torch.from_numpy(rng.randn(*shape).astype(np.float32))
            want, g, xd = net(x), _on(net, dev), x.to(dev)
            got = g(xd)
            pairs = zip(got, want) if kind == "detection" else [(got, want)]
            for i, (a, b) in enumerate(pairs):
                res["err"][f"{kind}{i}"] = _close(a, b, NET_TOL,
                                                  f"{kind} net output {i}")
            res["ms"][kind] = _time_ms(lambda: g(xd))
        net = seed_(RetinaFace(), 51)
        x = torch.from_numpy(rng.randn(1, 3, 640, 640).astype(np.float32) * 50)
        want, g, xd = net(x), _on(net, dev), x.to(dev)
        got = g(xd)
        res["err"]["retinaface_loc"] = _close(got[0], want[0], RF_LOC_TOL,
                                              "RetinaFace loc")
        res["err"]["retinaface_conf"] = _close(got[1], want[1], RF_CONF_TOL,
                                               "RetinaFace conf")
        res["ms"]["retinaface"] = _time_ms(lambda: g(xd))
    return res


def _video_frames(path: str) -> list:
    import cv2
    cap = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(cv2.cvtColor(f, cv2.COLOR_BGR2RGB))
    cap.release()
    return frames


def _check_rvm(dev, net, frames) -> dict:
    """RVM over the video at ``RVM_RATIO`` carrying its state, and frame 0
    at full resolution, card against CPU; the net's ms a frame (CUDA
    events over the stream) and the backend's frames/s, launches and idle
    share (torch.profiler)."""
    from havatar_tpu_torch.preprocess.matting import RVMBackend
    g = _on(net, dev)
    srcs = [torch.from_numpy(f).permute(2, 0, 1)[None].float() / 255.0
            for f in frames]
    res: dict = {}
    with torch.inference_mode():
        want = net(srcs[0])
        got = g(srcs[0].to(dev))
        res["full_err"] = max(
            _close(a, b, dict(atol=RVM_FULL_ATOL, rtol=0),
                   f"RVM frame 0 at ratio 1.0, output {i}")
            for i, (a, b) in enumerate(zip(got[:2] + tuple(got[2]),
                                           want[:2] + tuple(want[2]))))
        rec_c, rec_g, err = (None,) * 4, (None,) * 4, 0.0
        for k, s in enumerate(srcs):
            fw, pw, rec_c = net(s, rec_c, RVM_RATIO)
            fg, pg, rec_g = g(s.to(dev), rec_g, RVM_RATIO)
            for i, (a, b) in enumerate(zip((fg, pg) + tuple(rec_g),
                                           (fw, pw) + tuple(rec_c))):
                err = max(err, _close(
                    a, b, dict(atol=RVM_REFINED_ATOL, rtol=0),
                    f"RVM frame {k} at ratio {RVM_RATIO}, output {i}"))
            pha = pg.float()
            _check(0 < float(pha.mean()) < 1, f"phase 13: RVM frame {k}'s "
                   "alpha is blank or full")
        res["stream_err"] = err
        sd = [s.to(dev) for s in srcs]

        def stream():
            rec = (None,) * 4
            for s in sd:
                rec = g(s, rec, RVM_RATIO)[2]

        res["net_ms"] = _time_ms(stream, iters=3, warmup=1) / len(sd)
    backend = RVMBackend(g, RVM_RATIO, dev)
    for f in frames:
        backend.alpha(f)
    backend.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for f in frames:
        backend.alpha(f)
    res["backend_ms"] = (time.perf_counter() - t0) * 1e3 / len(frames)
    backend.reset()
    profile_device(lambda i: backend.alpha(frames[i]), len(frames),
                   res["backend_ms"], "13 rvm", "frame")
    return res


def _check_tracker(dev, files: dict, frames) -> dict:
    """The tracker (landmark type 3, detection and gaze nets, head pose,
    features) over the video on the card against the CPU; its ms a frame
    on the host clock, launches and idle share."""
    from havatar_tpu_torch.preprocess.tracker import Tracker
    H, W = frames[0].shape[:2]
    kw = dict(detect_weights=files["detection"], gaze_weights=files["gaze"],
              estimate_pose=True, extract_features=True)
    trackers = {d: Tracker.from_weights(W, H, files["landmark"], device=d,
                                        **kw) for d in (dev, "cpu")}
    res = {"px": 0.0, "eye_px": 0.0, "faces": 0}
    for k, f in enumerate(frames):
        out = {}
        for d, tr in trackers.items():
            np.random.seed(k)                 # headpose.adjust draws
            out[d] = tr.predict(f)
        got, want = out[dev], out["cpu"]
        _check(len(got) == len(want), f"phase 13: tracker frame {k}: "
               f"{len(got)} faces on the card, {len(want)} on the CPU")
        _check(k > 0 or len(got) == 1, "phase 13: the tracker found no face "
               "in frame 0")
        for a, b in zip(got, want):
            _check(abs(a.conf - b.conf) < 1e-4, f"phase 13: tracker frame "
                   f"{k}'s confidence {a.conf} vs {b.conf}")
            res["px"] = max(res["px"], float(np.abs(a.lms - b.lms).max()))
            res["eye_px"] = max(res["eye_px"], float(np.abs(
                a.eye_state - b.eye_state).max()))
            _check(a.quaternion is not None and bool(
                np.isfinite(a.quaternion).all()) and abs(
                np.linalg.norm(a.quaternion) - 1) < 1e-3,
                f"phase 13: tracker frame {k}'s head pose")
            _check(len(a.features) == 14 and all(
                np.isfinite(v) for v in a.features.values()),
                f"phase 13: tracker frame {k}'s features")
        res["faces"] += len(got)
    _check(res["px"] <= LM_PX_ATOL and res["eye_px"] <= LM_PX_ATOL,
           f"phase 13: tracker landmarks {res['px']:.3e} px, eyes "
           f"{res['eye_px']:.3e} px, card vs CPU (bound {LM_PX_ATOL})")
    tr = Tracker.from_weights(W, H, files["landmark"], device=dev, **kw)
    for f in frames:
        tr.predict(f)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for f in frames:
        tr.predict(f)
    res["ms"] = (time.perf_counter() - t0) * 1e3 / len(frames)
    profile_device(lambda i: tr.predict(frames[i]), len(frames), res["ms"],
                   "13 tracker", "frame")
    return res


def _onnx_graph(rng):
    """A mobile-net stem as an ONNX graph built in code: an asymmetric-pad
    stride-2 conv, a depthwise FusedConv (Clip 0..6), a max-pool, a 1x1
    conv, HardSwish, an align-corners Resize, the global pool and a Gemm."""
    from havatar_tpu_torch.preprocess.onnx_rt import OnnxGraph, OnnxNode

    def w(*shape):
        return (rng.randn(*shape) / math.sqrt(np.prod(shape[1:]))).astype(
            np.float32)

    nodes = [
        OnnxNode("Conv", ["x", "w1", "b1"], ["c1"],
                 {"strides": [2, 2], "pads": [0, 0, 1, 1]}),
        OnnxNode("FusedConv", ["c1", "w2", "b2"], ["c2"],
                 {"group": 16, "pads": [1, 1, 1, 1], "activation": "Clip",
                  "activation_params": [0.0, 6.0]}),
        OnnxNode("MaxPool", ["c2"], ["p"], {"kernel_shape": [3, 3],
                                           "strides": [2, 2],
                                           "pads": [1, 1, 1, 1]}),
        OnnxNode("Conv", ["p", "w3"], ["c3"], {}),
        OnnxNode("HardSwish", ["c3"], ["h"], {}),
        OnnxNode("Resize", ["h", "", "", "size"], ["r"],
                 {"mode": "linear",
                  "coordinate_transformation_mode": "align_corners"}),
        OnnxNode("GlobalAveragePool", ["r"], ["g"], {}),
        OnnxNode("Flatten", ["g"], ["f"], {}),
        OnnxNode("Gemm", ["f", "w4", "b4"], ["y"], {"transB": 1}),
        OnnxNode("Softmax", ["y"], ["s"], {"axis": 1})]
    inits = {"w1": w(16, 3, 3, 3), "b1": w(16, 1) * 0.1, "w2": w(16, 1, 3, 3),
             "b2": w(16, 1) * 0.1, "w3": w(32, 16, 1, 1),
             "size": np.asarray([4, 32, 112, 112], np.int64),
             "w4": w(10, 32), "b4": w(10, 1)[:, 0] * 0.1}
    inits["b1"], inits["b2"] = inits["b1"][:, 0], inits["b2"][:, 0]
    return OnnxGraph(nodes, inits, ["x"], ["r", "s"])


def _check_onnx(dev) -> dict:
    from havatar_tpu_torch.preprocess.onnx_rt import OnnxModel
    rng = np.random.RandomState(52)
    graph = _onnx_graph(rng)
    x = torch.from_numpy(rng.randn(4, 3, 224, 224).astype(np.float32))
    want = OnnxModel(graph, "cpu")(x)
    model = OnnxModel(graph, dev)
    xd = x.to(dev)
    got = model(xd)
    err = max(_close(a, b, ONNX_TOL, f"onnx_rt graph output {i}")
              for i, (a, b) in enumerate(zip(got, want)))
    return {"err": err, "ms": _time_ms(lambda: model(xd))}


def _run_cli_with_nets(root: str, inp: dict, files: dict) -> dict:
    """``cli/fit_video.main`` with the three network flags on phase 12's
    inputs, the fit shortened (phase 12 runs it at its defaults); the crop,
    every mask nonblank, and the split."""
    import cv2
    from havatar_tpu_torch.cli import fit_video
    base = os.path.join(root, "out_nets")
    t0 = time.perf_counter()
    out = fit_video.main([
        "--video_path", inp["video"], "--base_dir", base,
        "--faceverse_path", inp["fv_path"], "--exp52_path", inp["exp52_path"],
        "--lms_dir", inp["lms_dir"], "--lm_weights", files["landmark"],
        "--detect_weights", files["detection"], "--rvm_path", files["rvm"],
        "--rvm_jax"] + NET_FIT_FLAGS)
    wall = time.perf_counter() - t0
    with open(os.path.join(base, "crop_param.json")) as fh:
        top, left, size, pad = json.load(fh)
    _check(size > 0 and pad == FIT_RES // 2, f"phase 13: the tracker's crop "
           f"{[top, left, size, pad]}")
    means = []
    for d in ("mv_rgb", "mv_mask"):
        names = sorted(os.listdir(os.path.join(base, f"{d}{FIT_RES}", "0")))
        _check(names == sorted(f"{i}.png" for i in range(FIT_FRAMES)),
               f"phase 13: {d} holds {names}")
    for i in range(FIT_FRAMES):
        m = cv2.imread(os.path.join(base, f"mv_mask{FIT_RES}", "0", f"{i}.png"),
                       cv2.IMREAD_GRAYSCALE)
        means.append(float(m.mean()))
        _check(0 < means[-1] < 255, f"phase 13: mask {i} is blank or full")
    with open(out["split"]) as fh:
        fidx = sorted(f["fidx"] for f in json.load(fh)["frames"])
    _check(fidx == list(range(10, FIT_FRAMES)),
           f"phase 13: the split holds frames {fidx}")
    _check(out["frames"] == [str(i) for i in range(FIT_FRAMES)],
           f"phase 13: fitted frames {out['frames']}")
    return {"wall": wall, "crop": [top, left, size, pad],
            "mask_mean": float(np.mean(means))}


def write_net_weights(root: str) -> dict:
    """Seeded weight files in the reference's key layouts under
    ``root/nets``: the landmark net (type 3) and the detection net with
    ``confident_heads_``, the gaze net, RVM. Returns their paths by kind."""
    from havatar_tpu_torch.preprocess import landmark_net as L
    from havatar_tpu_torch.preprocess.rvm import seeded_rvm
    files = {}
    os.makedirs(os.path.join(root, "nets"), exist_ok=True)
    for kind, make in (
            ("landmark", lambda: L.seeded_net("landmark", 60, 3, True)),
            ("detection", lambda: L.seeded_net("detection", 61,
                                               confident=True)),
            ("gaze", lambda: L.seeded_net("gaze", 62)),
            ("rvm", lambda: seeded_rvm(RVM_SEED))):
        files[kind] = os.path.join(root, "nets", f"{kind}.pth")
        torch.save(make().state_dict(), files[kind])
    return files


def phase_networks(dev, root: str, inp: dict) -> None:
    """Phase 13 (see the module docstring), in ``root`` beside phase 12's
    inputs ``inp``."""
    from havatar_tpu_torch.preprocess.rvm import seeded_rvm
    t0 = time.perf_counter()
    live = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    nets = _check_nets(dev)
    print(f"[13 networks] {smi}: ms a call (CUDA events, seeded weights, "
          f"full width): " + json.dumps(
              {k: round(v, 4) for k, v in nets["ms"].items()}), flush=True)
    print("[13 networks] max err card vs CPU: " + json.dumps(
        {k: float(f"{v:.3e}") for k, v in nets["err"].items()}), flush=True)
    files = write_net_weights(root)
    frames = _video_frames(inp["video"])
    _check(len(frames) == FIT_FRAMES, f"phase 13: read {len(frames)} frames")
    rvm = _check_rvm(dev, seeded_rvm(RVM_SEED), frames)
    print(f"[13 networks] {smi}: RVM {FIT_RES}^2 at ratio {RVM_RATIO}: net "
          f"{rvm['net_ms']:.4f} ms a frame ({1e3 / rvm['net_ms']:.1f} "
          f"frames/s, CUDA events over the {FIT_FRAMES}-frame stream); "
          f"backend (upload, net, alpha to the host) {rvm['backend_ms']:.4f} "
          f"ms a frame ({1e3 / rvm['backend_ms']:.1f} frames/s, host clock); "
          f"max err card vs CPU {rvm['stream_err']:.3e} over the stream, "
          f"{rvm['full_err']:.3e} at ratio 1.0", flush=True)
    trk = _check_tracker(dev, files, frames)
    print(f"[13 networks] {smi}: tracker (landmark type 3, detection, gaze, "
          f"pose, features) {trk['ms']:.4f} ms a frame (host clock, "
          f"{FIT_FRAMES} frames, {trk['faces']} faces); landmarks card vs "
          f"CPU {trk['px']:.3e} px, eyes {trk['eye_px']:.3e} px", flush=True)
    onnx = _check_onnx(dev)
    print(f"[13 networks] onnx_rt graph (4 x 3 x 224^2): {onnx['ms']:.4f} ms "
          f"a call; max err card vs CPU {onnx['err']:.3e}", flush=True)
    cli = _run_cli_with_nets(root, inp, files)
    peak = (torch.cuda.max_memory_allocated() - live) / 2 ** 30
    print(f"[13 networks] cli/fit_video.py --lm_weights --detect_weights "
          f"--rvm_path --rvm_jax ({' '.join(NET_FIT_FLAGS)}): "
          f"{cli['wall']:.2f} s; crop {cli['crop']}, mean mask "
          f"{cli['mask_mean']:.1f} of 255; phase peak device memory "
          f"{peak:.3f} GiB above the {live / 2 ** 30:.3f} GiB live before "
          f"it; phase {time.perf_counter() - t0:.1f} s", flush=True)


def phase_kernel_line(captured, launches, serve_launches) -> list:
    """Each kernel on the inputs the frame gave it: error against its twin,
    its time and the twin's (CUDA events), and its bound. ``launches`` is
    the count over the five frames of the kernel's own configuration;
    ``launches_serve`` the count over the CLI's fast runs (quad kernels)."""
    from havatar_tpu_torch.ops import march as M
    rows = []
    for name, kernel, plain, compare, bound_fn, replaces in (
            ("march_coarse", M.march_coarse, M.march_coarse_gather_plain,
             compare_coarse, coarse_bound,
             "havatar_tpu/ops/pallas_march.py:236"),
            ("march_fine", M.march_fine, M.march_fine_gather_plain,
             compare_fine,
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
            errs = compare(got, plain(*a, **kw), "phase 11")
            ms = _time_ms(lambda: kernel(*a, **kw))
            plain_ms = _time_ms(lambda: plain(*a, **kw), iters=5)
            stage = (_stage_times(kernel, a, kw, *captured["stages"][name],
                                  bound_fn(a, got, old_contract=True)[0])
                     if name in captured["stages"] else {})
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
            "bound_by": by, **stage, "library_ms": None})
    return rows


def _stage_times(kernel, a, kw, cells_fn, quad_fn, pts, planes,
                 bound_old: float) -> dict:
    """A quad kernel's input stage on the frame's own points: its time
    (``stage_ms``: ``field_inputs_cells``), with the kernel (``op_ms``),
    and the corner-rows stage the kernel's old contract took instead
    (``gather_ms``: ``field_inputs_quad``, the [R, S, 8C] gather with the
    corner weights and posenc); ``bound_old_contract_ms`` is the kernel's
    bound had it read those corner rows."""
    R, S = a[2].shape[:2]

    def stage():
        rows, aux = cells_fn(pts, planes)
        return rows.reshape(R, S, 2), aux.reshape(R, S, aux.shape[-1])

    _check(all(torch.equal(x, y) for x, y in zip(stage(), a[2:4])),
           "phase 11: the captured input stage does not give the kernel's "
           "cells and aux")
    return {"bound_old_contract_ms": bound_old,
            "stage_ms": _time_ms(stage),
            "op_ms": _time_ms(lambda: kernel(*a[:2], *stage(), *a[4:], **kw)),
            "gather_ms": _time_ms(lambda: quad_fn(pts, planes))}


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
    golden_coarse = phase_golden(dev)
    from havatar_tpu_torch.ops.field import fused_field_eval
    fused_field_eval.launches = 0     # phases 4 to 9 must leave it so
    fs, inputs, frames, launches, captured = phase_frames(dev)
    frame_ms = phase_timing(fs, inputs)
    phase_profile(fs, inputs, frame_ms)
    fs_x, launches_x, captured_x = phase_frames_reduced(dev, inputs, fs,
                                                        frames)
    phase_timing(fs_x, inputs, tag="5 reduced", suffix="_x")
    del fs_x, frames
    serve_launches = phase_serve(dev, fs, frame_ms)
    del fs
    torch.cuda.empty_cache()
    phase_mlp_kernels(dev)
    with tempfile.TemporaryDirectory(prefix="havatar_train_") as root:
        train_counts, bf16_counts, train_captured, data, ckpt = phase_train(
            dev, root)
        torch.cuda.empty_cache()
        hd_counts, hd_bf16_counts, hd_captured = phase_hd(dev, root, data,
                                                          ckpt)
    torch.cuda.empty_cache()
    field_rows = phase_field(dev, golden_coarse)
    del golden_coarse
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="havatar_fit_") as root:
        inp = phase_preprocess(dev, root)
        torch.cuda.empty_cache()
        phase_networks(dev, root, inp)
    rows = phase_kernel_line({**captured, **captured_x},
                             {**launches, **launches_x}, serve_launches)
    rows += mlp_kernel_rows(train_captured, train_counts, bf16_counts)
    rows += quad_kernel_rows(hd_captured, hd_counts, hd_bf16_counts)
    rows += field_rows
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.1f} s",
          flush=True)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
