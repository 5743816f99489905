"""Calibrated multi-view preprocessing CLI: per-view frames to the split.

Usage:
  python -m havatar_tpu_torch.cli.fit_video_mv --base_dir D \\
      --calib_file calib.json --faceverse_path F.npy --views 0 1 2 ... \\
      [--lms_root L] [--device cpu]

Port of ``havatar_tpu/cli/fit_video_mv.py``, with its flags and outputs
plus ``--device`` (default: the CUDA device, and it raises without one).
It reads per-view frames ``{base_dir}/mv_rgb{res}/{view}/{i}.png``, a raw
calibration JSON ({cam: {K, R, T}}) and each view's crop parameters
(``crop_param_mv.json``: {view: [top, left, resolution, pad]}), and writes
``calib_{res}.json``, each frame's ``coeffs.npy``, ``metaFace_extr.npz``,
three ortho condition renders and normals and ``finish`` marker under
``tracking/{i}/``, then ``mv_v31_all.json``.

The landmarks come from MediaPipe, or from precomputed
``{lms_root}/{view}/{i}.npy`` files (a missing file: no face in that
view). A frame with no valid view is skipped, one with fewer than 3 draws
a warning, and one whose ``finish`` marker exists is not fitted again.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from havatar_tpu_torch.device import resolve_device
from havatar_tpu_torch.preprocess import faceverse as fv
from havatar_tpu_torch.preprocess import fitting, landmarks, multiview
from havatar_tpu_torch.preprocess.pipeline import (
    make_transform,
    save_fitted_frame,
)


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--base_dir", type=str, required=True)
    p.add_argument("--calib_file", type=str, required=True)
    p.add_argument("--crop_params", type=str, default="",
                   help="JSON {view: [top, left, resolution, pad]}; default "
                        "reads {base_dir}/crop_param_mv.json")
    p.add_argument("--faceverse_path", type=str, required=True)
    p.add_argument("--exp52_path", type=str, default="")
    p.add_argument("--views", type=str, nargs="+", required=True)
    p.add_argument("--lms_root", type=str, default="",
                   help="precomputed landmarks {view}/{frame}.npy")
    p.add_argument("--tar_size", type=int, default=512)
    p.add_argument("--first_frame_iters", type=int, default=2000)
    p.add_argument("--frame_iters", type=int, default=100)
    p.add_argument("--base_zero_frame", type=str, default="10")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: CUDA, an error without it)")
    return p


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    """Runs the multi-view pipeline; returns what it did: ``frames`` (the
    fitted frame names in order), per frame ``valid_views``, ``fit_s`` and
    ``render_s`` (host seconds, each ending on a device-to-host copy),
    ``first_loss`` / ``last_loss``, and ``split`` (the split file)."""
    args = _parser().parse_args(argv)
    dev = resolve_device(args.device)
    import cv2

    crop_path = args.crop_params or os.path.join(args.base_dir,
                                                 "crop_param_mv.json")
    with open(crop_path) as f:
        crop_params = json.loads(f.read())
    calib = multiview.make_calib(args.calib_file, args.base_dir,
                                 {v: crop_params[v] for v in args.views},
                                 args.tar_size)

    model = fv.load_model_file(args.faceverse_path, args.exp52_path or None,
                               device=dev)
    cam_Ks = np.stack([np.asarray(calib["intrinsics"][v]["cam_K"],
                                  np.float32).reshape(3, 3)
                       for v in args.views])
    cam_Ts = np.stack([np.asarray(calib["intrinsics"][v]["cam_T"],
                                  np.float32).reshape(4, 4)
                       for v in args.views])
    cfg = fitting.FitConfig(img_size=args.tar_size)

    backends = {
        v: (landmarks.PrecomputedBackend(os.path.join(args.lms_root, v))
            if args.lms_root else landmarks.get_backend("mediapipe"))
        for v in args.views}

    img_root = os.path.join(args.base_dir, f"mv_rgb{args.tar_size}")
    save_dir = os.path.join(args.base_dir, "tracking")
    names = sorted(os.listdir(os.path.join(img_root, args.views[0])),
                   key=lambda s: int(s.split(".")[0]))

    state = fitting.init_fit_state(model.exp_dims, device=dev)
    prev_rot = torch.zeros(1, 3, device=dev)
    prev_trans = torch.zeros(1, 3, device=dev)
    fits = {
        True: multiview.make_fit_frame_mv(model, cam_Ks, cam_Ts, cfg,
                                          args.first_frame_iters,
                                          first_frame=True, fit_id=True),
        False: multiview.make_fit_frame_mv(model, cam_Ks, cam_Ts, cfg,
                                           args.frame_iters,
                                           first_frame=False, fit_id=False),
    }

    out: Dict[str, Any] = {"frames": [], "valid_views": {}, "fit_s": {},
                           "render_s": {}, "first_loss": {}, "last_loss": {}}
    for i, name in enumerate(names):
        fid = name.split(".")[0]
        out_dir = os.path.join(save_dir, fid)
        if os.path.exists(os.path.join(out_dir, "finish")):
            continue
        lms, valid = [], []
        for v in args.views:
            frame = cv2.cvtColor(cv2.imread(os.path.join(img_root, v, name)),
                                 cv2.COLOR_BGR2RGB)
            b = backends[v]
            if hasattr(b, "set_frame"):
                b.set_frame(fid)
            lm = b.detect(frame)
            valid.append(1.0 if lm is not None else 0.0)
            lms.append(lm if lm is not None
                       else np.zeros((478, 2), np.float32))
        if sum(valid) < 1:
            print(f"frame {fid}: no valid views, skipping")
            continue
        if sum(valid) < 3:
            print(f"WARNING! frame {fid}: too few faces detected")

        t0 = time.perf_counter()
        state, losses = fits[i == 0](
            state, torch.from_numpy(np.stack(lms)).to(dev),
            torch.tensor(valid), prev_rot, prev_trans)
        prev_rot, prev_trans = state.rot, state.trans
        losses = losses.cpu()
        t1 = time.perf_counter()
        save_fitted_frame(model, fitting.pack(state), save_dir, fid)
        t2 = time.perf_counter()
        out["frames"].append(fid)
        out["valid_views"][fid] = int(sum(valid))
        out["fit_s"][fid], out["render_s"][fid] = t1 - t0, t2 - t1
        out["first_loss"][fid] = float(losses[0])
        out["last_loss"][fid] = float(losses[-1])
        if i % 50 == 0:
            print(f"frame {fid}: mv fit loss {float(losses[-1]):.5f} "
                  f"({int(sum(valid))}/{len(args.views)} views)")

    split = make_transform(args.base_dir, save_dir, calib, list(args.views),
                           args.base_zero_frame)
    print(f"split written: {split}")
    out["split"] = split
    return out


if __name__ == "__main__":
    main()
