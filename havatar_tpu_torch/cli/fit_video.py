"""Monocular preprocessing CLI: a video to the training split.

Usage:
  python -m havatar_tpu_torch.cli.fit_video --video_path V.mp4 --base_dir OUT \\
      --lms_dir LMS [--faceverse_path F.npy] [--lm_weights LM.pth \\
      [--detect_weights DET.pth]] [--rvm_path RVM [--rvm_jax]] \\
      [--avatar_tracking_dir AVATAR_DIR] [--device cpu]

Port of ``havatar_tpu/cli/fit_video.py``, with its flags and outputs plus
``--device`` (default: the CUDA device, and it raises without one). It runs
frame extraction and the fixed face crop, matting (RVM, or the masks
already in ``mv_mask{tar_size}/0``), the FaceVerse fit of every frame
(frame 0 with the first-frame optimizer and the identity, frames 1-9 with
the identity, the rest without), each frame's ``coeffs.npy``,
``metaFace_extr.npz``, ``finish`` marker and three ortho condition renders
and normals, then ``sv_v31_all.json`` (or the ``drive_*.json`` split with
``--avatar_tracking_dir``).

Needs the FaceVerse model file (a download in the reference too) and
landmarks for the fit: MediaPipe, or precomputed ``{frame}.npy`` files
(``--lms_dir``). The crop takes frame 0's landmarks from the same source,
or, with ``--lm_weights``, from the repository's OpenSeeFace tracker
(preprocess/tracker.py; the reference's split: OpenSeeFace for the crop,
MediaPipe for the fit's landmarks), which finds the face with the
detection net of ``--detect_weights`` or, without it, crops the whole
frame. ``--rvm_path F`` mats with F as an RVM TorchScript file, or with
``--rvm_jax`` through the repository's own RVM network
(preprocess/rvm.py; the flag keeps the JAX CLI's name).
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from havatar_tpu_torch.device import resolve_device
from havatar_tpu_torch.preprocess import faceverse as fv
from havatar_tpu_torch.preprocess import fitting, landmarks, matting, video
from havatar_tpu_torch.preprocess.pipeline import (
    make_animation_transform,
    make_transform,
    save_fitted_frame,
)
from havatar_tpu_torch.preprocess.rasterizer import (
    DEFAULT_CHUNK,
    chunk_peak_bytes,
)
from havatar_tpu_torch.preprocess.tracker import Tracker

FOCAL = 1315.0          # the reference's fitting intrinsics (fit_video.py:31)
EARLY_FRAMES = 10       # frames 1..9 still fit the identity


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--video_path", type=str, required=True)
    p.add_argument("--base_dir", type=str, required=True)
    p.add_argument("--avatar_tracking_dir", type=str, default="")
    p.add_argument("--faceverse_path", type=str,
                   default="metamodel/v3/faceverse_v3_1.npy")
    p.add_argument("--exp52_path", type=str,
                   default="metamodel/v3/exBase_52.npy")
    p.add_argument("--lms_dir", type=str, default="",
                   help="precomputed landmark .npy dir (else mediapipe)")
    p.add_argument("--lm_weights", type=str, default="",
                   help="OpenSeeFace landmark weights (lm_model3.pth or an "
                        ".npz of it): the repository's tracker "
                        "(preprocess/tracker.py) finds the crop instead of "
                        "the fit's landmark source")
    p.add_argument("--detect_weights", type=str, default="",
                   help="OpenSeeFace detection.pth for the tracker's face "
                        "detector (else the tracker crops the whole frame)")
    p.add_argument("--rvm_path", type=str, default="",
                   help="RVM weights for matting: a TorchScript file, or "
                        "with --rvm_jax the official .pth (else the masks "
                        "in mv_mask{tar_size}/0)")
    p.add_argument("--rvm_jax", action="store_true",
                   help="run --rvm_path through the repository's own RVM "
                        "network (preprocess/rvm.py) instead of TorchScript")
    p.add_argument("--tar_size", type=int, default=512)
    p.add_argument("--cam_dist", type=float, default=10.0)
    p.add_argument("--first_frame_iters", type=int, default=2000)
    p.add_argument("--frame_iters", type=int, default=100)
    p.add_argument("--base_zero_frame", type=str, default="10")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: CUDA, an error without it)")
    return p


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    """Runs the pipeline; returns what it did: ``frames`` (the fitted frame
    names in order), per frame ``fit_s`` and ``render_s`` (host seconds,
    each ending on a device-to-host copy), ``first_loss`` / ``last_loss``
    (the fit's loss at its first and last iteration), and ``split`` (the
    split file)."""
    args = _parser().parse_args(argv)
    dev = resolve_device(args.device)
    import cv2

    lm_backend = (landmarks.PrecomputedBackend(args.lms_dir) if args.lms_dir
                  else landmarks.get_backend("mediapipe"))

    # 1. frame extraction and the fixed crop from frame 0's landmarks: the
    # tracker's 66 with --lm_weights, else the fit's landmark source
    if args.lm_weights:
        def detect(frame_rgb):
            h, w = frame_rgb.shape[:2]
            tr = Tracker.from_weights(
                w, h, args.lm_weights,
                detect_weights=args.detect_weights or None, device=dev)
            preds = tr.predict(frame_rgb)
            return preds[0].lms[:66, :2] if preds else None

        crop_fn = video.crop_params_from_landmarks
    else:
        def detect(frame_rgb):
            if hasattr(lm_backend, "set_frame"):
                lm_backend.set_frame("0")
            return lm_backend.detect(frame_rgb)

        crop_fn = video.crop_params_from_mediapipe

    n = video.extract_video_frames(args.video_path, args.base_dir, detect,
                                   dst_resolution=args.tar_size,
                                   crop_fn=crop_fn)
    print(f"extracted {n + 1} frames")

    # 2. matting
    if args.rvm_path and args.rvm_jax:
        mb = matting.RVMBackend(args.rvm_path, device=dev)
    elif args.rvm_path:
        mb = matting.RVMTorchBackend(args.rvm_path, device=dev)
    else:
        mask_dir = os.path.join(args.base_dir, f"mv_mask{args.tar_size}", "0")
        if not os.path.isdir(mask_dir):
            raise RuntimeError(
                "no RVM model given and no precomputed masks found; supply "
                f"--rvm_path or pre-fill {mask_dir}")
        mb = matting.PrecomputedBackend(mask_dir)
    video.run_matting(args.base_dir, mb, args.tar_size)

    # 3. the FaceVerse fit of each frame, and its condition renders
    model = fv.load_model_file(
        args.faceverse_path,
        args.exp52_path if os.path.exists(args.exp52_path) else None,
        device=dev)
    half = args.tar_size / 2
    intr = np.asarray([FOCAL, FOCAL, half, half], np.float32)
    cam_K = np.asarray([[FOCAL, 0, half], [0, FOCAL, half], [0, 0, 1]],
                       np.float32)
    fit_cfg = fitting.FitConfig(img_size=args.tar_size, cam_dist=args.cam_dist)
    print(f"rasterizer: {DEFAULT_CHUNK} faces a chunk, "
          f"{chunk_peak_bytes(256, DEFAULT_CHUNK) / 2 ** 30:.2f} GiB working "
          f"set; {model.tri.shape[0]} faces, {model.num_vertex} vertices")

    img_dir = os.path.join(args.base_dir, f"mv_rgb{args.tar_size}", "0")
    save_dir = os.path.join(args.base_dir, "tracking")
    names = sorted(os.listdir(img_dir), key=lambda s: int(s.split(".")[0]))

    state = fitting.init_fit_state(model.exp_dims, device=dev)
    prev_rot = torch.zeros(1, 3, device=dev)
    prev_trans = torch.zeros(1, 3, device=dev)
    fit_first = fitting.make_fit_frame(model, intr, fit_cfg,
                                       args.first_frame_iters,
                                       first_frame=True, fit_id=True)
    fit_early = fitting.make_fit_frame(model, intr, fit_cfg, args.frame_iters,
                                       first_frame=False, fit_id=True)
    fit_rest = fitting.make_fit_frame(model, intr, fit_cfg, args.frame_iters,
                                      first_frame=False, fit_id=False)

    out: Dict[str, Any] = {"frames": [], "fit_s": {}, "render_s": {},
                           "first_loss": {}, "last_loss": {}}
    for i, name in enumerate(names):
        fid = name.split(".")[0]
        out_dir = os.path.join(save_dir, fid)
        if os.path.exists(os.path.join(out_dir, "finish")):
            continue
        frame = cv2.cvtColor(cv2.imread(os.path.join(img_dir, name)),
                             cv2.COLOR_BGR2RGB)
        if hasattr(lm_backend, "set_frame"):
            lm_backend.set_frame(fid)
        lms = lm_backend.detect(frame)
        if lms is None:
            print(f"frame {fid}: no face, skipping")
            continue
        fit = (fit_first if i == 0
               else fit_early if i < EARLY_FRAMES else fit_rest)
        t0 = time.perf_counter()
        state, losses = fit(state, torch.from_numpy(lms).to(dev), prev_rot,
                            prev_trans)
        prev_rot, prev_trans = state.rot, state.trans
        losses = losses.cpu()
        t1 = time.perf_counter()
        # the files and condition renders (drive mode transplants
        # expressions later)
        save_fitted_frame(model, fitting.pack(state), save_dir, fid)
        t2 = time.perf_counter()
        out["frames"].append(fid)
        out["fit_s"][fid], out["render_s"][fid] = t1 - t0, t2 - t1
        out["first_loss"][fid] = float(losses[0])
        out["last_loss"][fid] = float(losses[-1])
        if i % 50 == 0:
            print(f"frame {fid}: lm fit loss {float(losses[-1]):.5f}")

    # 4. the split
    calib = {
        "img_res": args.tar_size,
        "intrinsics": {"0": {"cam_K": cam_K.tolist(),
                             "cam_T": np.eye(4).tolist()}},
    }
    if args.avatar_tracking_dir:
        split = make_animation_transform(
            args.base_dir, save_dir, calib, args.base_zero_frame, cam_K,
            avatar_baseframe_path=os.path.join(args.avatar_tracking_dir,
                                               args.base_zero_frame),
            drive_dir_name="drive")
    else:
        split = make_transform(args.base_dir, save_dir, calib, ["0"],
                               args.base_zero_frame)
    print(f"split written: {split}")
    out["split"] = split
    return out


if __name__ == "__main__":
    main()
