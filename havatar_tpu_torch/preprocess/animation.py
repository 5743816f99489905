"""Cross-driving condition renders: video- and audio-driven reenactment.

Port of ``havatar_tpu/preprocess/animation.py`` (the reference's
data_preprocessing/animation.py:62-134): load the avatar's base
coefficients; for each drive frame, move the actor's expression (absolute,
or its change from the actor's first frame) and pupils onto the avatar's
identity, and render the three ortho condition images into the drive
frame's directory. The audio mode reads a [T, 171] or [T, 121] sequence of
expression coefficients.

The coefficient arithmetic is host numpy, the JAX package's code; the
renders run on the device of the FaceVerse model (``fv.load_model_file``'s
``device``, the CUDA device when none is named).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from havatar_tpu_torch.preprocess import faceverse as fv
from havatar_tpu_torch.preprocess.pipeline import render_condition_set


def transplant_coeffs(model: fv.FaceVerseModel, avatar_coeffs: np.ndarray,
                      actor_coeffs: np.ndarray,
                      actor_base_coeffs: Optional[np.ndarray] = None,
                      incre_expr: bool = True) -> np.ndarray:
    """Move the actor's expression and pupils onto the avatar's identity
    (animation.py:97-106; also fit_video.py:253-263)."""
    e0, e1 = fv.ID_DIMS, fv.ID_DIMS + model.exp_dims
    all_dims = fv.ID_DIMS + model.exp_dims + fv.TEX_DIMS
    out = np.asarray(avatar_coeffs, np.float32).copy()
    actor = np.asarray(actor_coeffs, np.float32)
    if incre_expr:
        if actor_base_coeffs is None:
            raise ValueError("incre_expr needs the actor's base coefficients")
        base = np.asarray(actor_base_coeffs, np.float32)
        out[..., e0:e1] = (actor[..., e0:e1] - base[..., e0:e1]) + out[..., e0:e1]
    else:
        out[..., e0:e1] = actor[..., e0:e1]
    out[..., all_dims + 33:all_dims + 37] = actor[..., all_dims + 33:all_dims + 37]
    return out


def _render_drive_frame(model: fv.FaceVerseModel, coeffs: np.ndarray,
                        out_dir: str) -> None:
    c = torch.from_numpy(np.asarray(coeffs, np.float32).reshape(1, -1))
    id_c, exp_c, tex_c, _, _, _, eye_c, _ = fv.split_coeffs(
        c.to(model.device), model.exp_dims)
    vs = fv.get_vs(model, id_c, exp_c, eye_c)[0]
    colors = fv.get_color(model, tex_c)[0]
    render_condition_set(model, vs, colors, out_dir)


def video_animation(model: fv.FaceVerseModel, video_tracking_dir: str,
                    avatar_baseframe_path: str, drive_dir_name: str,
                    incre_expr: bool = True, smooth_coeff: bool = False) -> int:
    """For each tracked drive frame (a directory with a ``finish`` marker,
    in string order of the names, as JAX lists them): transplant and render
    the conditions into ``{frame}/{drive_dir_name}/`` (animation.py:86-109).
    ``smooth_coeff`` first smooths the actor's sequence over time (a
    Gaussian of sigma 1 frame). Returns the number of frames."""
    avatar_coeffs = np.load(os.path.join(avatar_baseframe_path, "coeffs.npy"))
    names = sorted(
        n for n in os.listdir(video_tracking_dir)
        if os.path.isdir(os.path.join(video_tracking_dir, n))
        and os.path.exists(os.path.join(video_tracking_dir, n, "finish")))
    seq = np.stack([np.load(os.path.join(video_tracking_dir, n, "coeffs.npy"))
                    for n in names], 0)
    if smooth_coeff:
        from scipy.ndimage import gaussian_filter1d

        seq = gaussian_filter1d(seq, sigma=1.0, axis=0)
    base = seq[0]
    for name, actor in zip(names, seq):
        coeffs = transplant_coeffs(model, avatar_coeffs, actor, base, incre_expr)
        _render_drive_frame(model, coeffs,
                            os.path.join(video_tracking_dir, name, drive_dir_name))
    return len(names)


def audio_animation(model: fv.FaceVerseModel, audio_coeff_path: str,
                    avatar_baseframe_path: str, savedir: str,
                    incre_expr: bool = True, smooth_audio: bool = False) -> int:
    """Audio-predicted expression sequences to condition renders in
    ``savedir/{row}/`` (animation.py:112-134). A 171-d row is a whole
    expression vector; a 121-d row is written to ``exp[40:161]``, which
    assumes ``exp_dims == 171`` as the JAX package does. Returns the number
    of rows."""
    avatar_coeffs = np.load(os.path.join(avatar_baseframe_path,
                                         "coeffs.npy")).astype(np.float32)
    seq = np.load(audio_coeff_path)
    if smooth_audio:
        from scipy.ndimage import gaussian_filter1d

        seq = gaussian_filter1d(seq, sigma=1.0, axis=0)
    e0 = fv.ID_DIMS
    for idx in range(seq.shape[0]):
        coeff = seq[idx]
        if len(coeff) not in (171, 121):
            raise ValueError(f"an audio row has {len(coeff)} coefficients, "
                             "not 171 or 121")
        out = avatar_coeffs.copy()
        if len(coeff) == 171:
            sl = slice(e0, e0 + model.exp_dims)
            target = coeff[:model.exp_dims]
        else:
            sl = slice(e0 + 40, e0 + 161)
            target = coeff
        if incre_expr:
            out[..., sl] = out[..., sl] + target
        else:
            out[..., sl] = target
        _render_drive_frame(model, out, os.path.join(savedir, str(idx)))
    return int(seq.shape[0])
