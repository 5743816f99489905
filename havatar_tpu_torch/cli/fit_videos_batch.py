"""Dataset-scale FaceVerse fitting: many videos' frames to fitted assets.

Usage:
  python -m havatar_tpu_torch.cli.fit_videos_batch --videos_root R \\
      --save_root S --faceverse_path F.npy [--lms_root L] \\
      [--save_fvmask fvmask] [--save_lmscounter lmscounter] \\
      [--io_workers N] [--device cpu]

Port of ``havatar_tpu/cli/fit_videos_batch.py`` (the reference's
data_preprocessing/fit_videos_mp.py), with its flags and outputs plus
``--device`` (default: the CUDA device, and it raises without one). Each
video is a folder of ``{i}.png`` frames under ``--videos_root``. One
device fits the videos one after another, each video's frames in time
order (a frame's fit starts from the previous frame's); a pool of
``--io_workers`` threads decodes the frames and runs the landmark backend
for the next videos meanwhile. Only the consuming thread launches work on
the device, and videos are consumed in submission order, so the worker
count never changes the outputs.

Per frame it writes ``{save_root}/{video}/{i}/coeffs.npy``,
``metaFace_extr.npz`` (the head transform rebuilt from that frame's own
coefficients) and ``finish``; ``--save_fvmask`` and ``--save_lmscounter``
add the fitted mesh's silhouette and a landmark-contour image. A finished
video gets a ``finish`` marker and a video with a frame without a face a
``skip`` marker; both are passed over on the next run. The frames without
a face go to ``{save_root}/no_face_log.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from havatar_tpu_torch.device import resolve_device
from havatar_tpu_torch.preprocess import faceverse as fv
from havatar_tpu_torch.preprocess import fitting, landmarks
from havatar_tpu_torch.preprocess.pipeline import save_fitted_frame


def collect_pending(videos_root: str, save_root: str) -> List[str]:
    """The video folders under ``videos_root`` whose save folder has no
    ``finish`` or ``skip`` marker, sorted by name."""
    names = []
    for name in sorted(os.listdir(videos_root)):
        vdir = os.path.join(videos_root, name)
        if not os.path.isdir(vdir):
            continue
        sdir = os.path.join(save_root, name)
        if os.path.exists(os.path.join(sdir, "finish")) or \
                os.path.exists(os.path.join(sdir, "skip")):
            continue
        names.append(name)
    return names


def fit_video_frames(model: fv.FaceVerseModel, frames_lms: np.ndarray, intr,
                     cfg: fitting.FitConfig, iters_first: int,
                     iters_rest: int
                     ) -> Tuple[np.ndarray, List[float], fitting.FitState]:
    """Fit one video's frames in time order on the model's device: frame 0
    with the first-frame optimizer and the identity, the others without,
    each from the previous frame's state. Returns (coefficients [T, D],
    each frame's last-iteration loss, the final state).

    JAX's loop ends with an early-exit test (fit_videos_mp.py:189-192) that
    is a ``continue`` at the end of the loop body, so every frame takes its
    full iterations there; here too."""
    dev = model.device
    state = fitting.init_fit_state(model.exp_dims, device=dev)
    prev_rot = torch.zeros(1, 3, device=dev)
    prev_trans = torch.zeros(1, 3, device=dev)
    fit_first = fitting.make_fit_frame(model, intr, cfg, iters_first,
                                       first_frame=True, fit_id=True)
    fit_rest = fitting.make_fit_frame(model, intr, cfg, iters_rest,
                                      first_frame=False, fit_id=False)
    coeffs, losses = [], []
    for i in range(frames_lms.shape[0]):
        fit = fit_first if i == 0 else fit_rest
        state, frame_losses = fit(state, torch.from_numpy(
            np.asarray(frames_lms[i], np.float32)).to(dev), prev_rot,
            prev_trans)
        prev_rot, prev_trans = state.rot, state.trans
        coeffs.append(fitting.pack(state)[0])
        losses.append(frame_losses[-1])
    return (torch.stack(coeffs).cpu().numpy(),
            [float(v) for v in torch.stack(losses).cpu()], state)


# MediaPipe topology rings of the reference's landmark-counter debug image
# (facts of the MediaPipe mesh; fit_videos_mp.py:306-325)
_OUTER_MOUTH = [0, 267, 269, 270, 409, 291, 375, 321, 405, 314, 17, 84, 181,
                91, 146, 76, 185, 40, 39, 37]
_INNER_MOUTH = [13, 312, 311, 310, 415, 308, 324, 318, 402, 317, 14, 87, 178,
                88, 95, 78, 191, 80, 81, 82]
_LEFT_EYE = [33, 246, 161, 160, 159, 158, 157, 173, 133, 155, 154, 153, 145,
             144, 163, 7]
_RIGHT_EYE = [362, 398, 384, 385, 386, 387, 388, 466, 263, 249, 390, 373,
              374, 380, 381, 382]


def draw_lms_counter(img: np.ndarray, lms_proj: np.ndarray) -> np.ndarray:
    """Landmark-contour debug image: mouth rings (blue, 4 px), eye rings
    (green, 2 px), pupils (red dots) (fit_videos_mp.py:306-325)."""
    import cv2

    pts = np.round(lms_proj).astype(np.int32)
    out = cv2.polylines(img.copy(), [pts[_OUTER_MOUTH]], True, (255, 0, 0), 4)
    out = cv2.polylines(out, [pts[_INNER_MOUTH]], True, (255, 0, 0), 4)
    out = cv2.polylines(out, [pts[_LEFT_EYE]], True, (0, 255, 0), 2)
    out = cv2.polylines(out, [pts[_RIGHT_EYE]], True, (0, 255, 0), 2)
    out = cv2.circle(out, (pts[473, 0], pts[473, 1]), 4, [0, 0, 255], -1)
    out = cv2.circle(out, (pts[468, 0], pts[468, 1]), 4, [0, 0, 255], -1)
    return out


def render_fvmask(model: fv.FaceVerseModel, coeffs: np.ndarray, intr,
                  tar_size: int) -> np.ndarray:
    """Silhouette of the fitted mesh (fit_videos_mp.py:268-271): the mesh
    posed and projected on the device, each triangle's corners rounded to
    pixels and filled with ``cv2.fillPoly`` on the host -> [tar_size,
    tar_size] uint8, 255 inside."""
    import cv2

    c = torch.from_numpy(np.asarray(coeffs, np.float32)[None])
    id_c, exp_c, _, angles, _, trans, eye_c, scale = fv.split_coeffs(
        c.to(model.device), model.exp_dims)
    vs = fv.get_vs(model, id_c, exp_c, eye_c)
    vs_t = fv.rigid_transform(vs, fv.euler_rotation(angles), trans,
                              scale.abs())
    fx, fy, cx, cy = [float(v) for v in intr]
    proj = fv.project_points(vs_t, fx, fy, cx, cy)[0].cpu().numpy()
    tris = np.round(proj[model.tri.cpu().numpy()]).astype(np.int32)
    mask = np.zeros((tar_size, tar_size), np.uint8)
    cv2.fillPoly(mask, list(tris), 255)
    return mask


def load_video_landmarks(
    vdir: str, frame_names: List[str], lms_root: str, name: str
) -> Tuple[Optional[np.ndarray], Optional[str]]:
    """The IO stage of one video: decode every frame and run the landmark
    backend. Returns (landmarks [T, L, 2], None), or (None, the first frame
    without a face). Runs on an IO worker thread, on the host only."""
    import cv2

    backend = (landmarks.PrecomputedBackend(os.path.join(lms_root, name))
               if lms_root else landmarks.get_backend("mediapipe"))
    lms_all = []
    for f in frame_names:
        img = cv2.cvtColor(cv2.imread(os.path.join(vdir, f)),
                           cv2.COLOR_BGR2RGB)
        if hasattr(backend, "set_frame"):
            backend.set_frame(f.split(".")[0])
        lms = backend.detect(img)
        if lms is None:
            return None, f
        lms_all.append(lms)
    return np.stack(lms_all), None


def iter_videos_prefetched(pending: List[str], videos_root: str,
                           lms_root: str, io_workers: int,
                           prefetch: int = 2):
    """Yield (name, frame_names, landmarks or None, failed_frame) in
    ``pending`` order while the pool works ``prefetch`` videos ahead."""
    def frame_list(name):
        vdir = os.path.join(videos_root, name)
        return vdir, sorted(
            (f for f in os.listdir(vdir) if f.endswith((".png", ".jpg"))),
            key=lambda s: int(s.split(".")[0]))

    with ThreadPoolExecutor(max_workers=io_workers) as pool:
        queue = []
        names = list(pending)
        while names or queue:
            while names and len(queue) <= prefetch:
                name = names.pop(0)
                vdir, frames = frame_list(name)
                queue.append((name, frames, pool.submit(
                    load_video_landmarks, vdir, frames, lms_root, name)))
            name, frames, fut = queue.pop(0)
            lms, failed = fut.result()
            yield name, frames, lms, failed


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--videos_root", type=str, required=True,
                   help="root containing one frame folder per video")
    p.add_argument("--save_root", type=str, required=True)
    p.add_argument("--faceverse_path", type=str, required=True)
    p.add_argument("--exp52_path", type=str, default="")
    p.add_argument("--lms_root", type=str, default="",
                   help="precomputed landmarks: {video}/{frame}.npy")
    p.add_argument("--tar_size", type=int, default=512)
    p.add_argument("--iters_first", type=int, default=500)
    p.add_argument("--iters_rest", type=int, default=100)
    p.add_argument("--focal", type=float, default=4.2647,
                   help="EG3D-style normalized focal (fit_videos_mp.py:372)")
    p.add_argument("--save_fvmask", type=str, default=None,
                   help="also save each frame's mesh silhouette under "
                        "save_root/{video}/<save_fvmask>/")
    p.add_argument("--save_lmscounter", type=str, default=None,
                   help="also save each frame's landmark-contour image "
                        "under save_root/{video}/<save_lmscounter>/")
    p.add_argument("--io_workers", type=int,
                   default=min(8, os.cpu_count() or 1),
                   help="host threads for the frames' decode and landmarks "
                        "(the reference's Pool(8), fit_videos_mp.py:59-75)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: CUDA, an error without it)")
    return p


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    """Fits every pending video; returns what it did: ``pending`` (the
    video names found pending), ``fitted`` and ``skipped`` (names),
    ``frames`` (frames fitted), per video ``fit_s`` (host seconds of its
    fit, ending on a device-to-host copy) and ``last_loss``, ``wall_s``
    (the whole loop's host seconds) and ``no_face_log`` (its path, or
    None)."""
    args = _parser().parse_args(argv)
    dev = resolve_device(args.device)
    import cv2

    model = fv.load_model_file(args.faceverse_path, args.exp52_path or None,
                               device=dev)
    focal_px = args.focal * args.tar_size / 2
    intr = np.asarray([focal_px, focal_px, args.tar_size / 2,
                       args.tar_size / 2], np.float32)
    cfg = fitting.FitConfig(img_size=args.tar_size)

    no_face_log: Dict[str, str] = {}
    pending = collect_pending(args.videos_root, args.save_root)
    print(f"{len(pending)} videos pending ({args.io_workers} IO workers)")
    out: Dict[str, Any] = {"pending": list(pending), "fitted": [],
                           "skipped": [], "frames": 0, "fit_s": {},
                           "last_loss": {}, "no_face_log": None}
    t_start = time.perf_counter()
    for name, frame_names, lms_all, failed in iter_videos_prefetched(
            pending, args.videos_root, args.lms_root, args.io_workers):
        sdir = os.path.join(args.save_root, name)
        os.makedirs(sdir, exist_ok=True)
        if failed is not None:
            no_face_log[f"{name}/{failed}"] = "no_face"
            open(os.path.join(sdir, "skip"), "w").close()
            out["skipped"].append(name)
            continue

        t0 = time.perf_counter()
        coeffs, losses, _ = fit_video_frames(
            model, lms_all, intr, cfg, args.iters_first, args.iters_rest)
        out["fit_s"][name] = time.perf_counter() - t0
        for f, c in zip(frame_names, coeffs):
            fid = f.split(".")[0]
            # each frame's pose from its own coefficients: the fit's state
            # holds only the last frame's
            save_fitted_frame(model, torch.from_numpy(c[None]).to(dev), sdir,
                              fid, render=False)
            if args.save_fvmask:
                mdir = os.path.join(sdir, args.save_fvmask)
                os.makedirs(mdir, exist_ok=True)
                cv2.imwrite(os.path.join(mdir, f"{fid}.png"),
                            render_fvmask(model, c, intr, args.tar_size))
            if args.save_lmscounter:
                ldir = os.path.join(sdir, args.save_lmscounter)
                os.makedirs(ldir, exist_ok=True)
                lms_proj, _ = fv.forward_landmarks(
                    model, torch.from_numpy(c[None]).to(dev), *[
                        float(v) for v in intr])
                black = np.zeros((args.tar_size, args.tar_size, 3), np.uint8)
                cv2.imwrite(os.path.join(ldir, f"{fid}.png"),
                            draw_lms_counter(black, lms_proj[0].cpu().numpy()
                                             )[:, :, ::-1])
        open(os.path.join(sdir, "finish"), "w").close()
        out["fitted"].append(name)
        out["frames"] += len(frame_names)
        out["last_loss"][name] = losses[-1]
        print(f"{name}: {len(frame_names)} frames, "
              f"final lm loss {losses[-1]:.5f}")

    if no_face_log:
        out["no_face_log"] = os.path.join(args.save_root, "no_face_log.json")
        with open(out["no_face_log"], "w") as f:
            json.dump(no_face_log, f, indent=2)
    out["wall_s"] = time.perf_counter() - t_start
    return out


if __name__ == "__main__":
    main()
