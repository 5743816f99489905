"""Calibrated multi-view FaceVerse fitting.

Port of ``havatar_tpu/preprocess/multiview.py`` (the reference's
data_preprocessing/fit_video_mv.py): the intrinsics' adjustment for the
pad, crop and resize of each view (make_calib, fit_video_mv.py:627-669,
host numpy and JSON, the JAX package's code), the coefficient forward
through a view's camera transform (the camT branch of
FaceVerseModel.forward, FaceVerseModel_v3.py:266-276), and the joint fit
of one frame's landmarks in every valid view.

The joint fit is not the single-view fit with more views: one Adam for all
iterations (no fine optimizer), the scale fitted with the identity by
default, and the landmark loss summed over the valid views and divided by
their number before the regularisers are added. All V views go through one
batched forward, so an iteration makes as many launches at V = 4 as at
V = 1.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from havatar_tpu_torch.preprocess import faceverse as fv
from havatar_tpu_torch.preprocess import fitting


def adjust_intrinsic(cam_K: np.ndarray, mode: str, param) -> np.ndarray:
    """'resize' (fx, fy scale), 'crop' (left, top), 'padding' (left, top)
    (fit_video_mv.py:628-643)."""
    K = cam_K.copy()
    if mode == "resize":
        K[0] *= param[0]
        K[1] *= param[1]
    elif mode == "crop":
        K[0, 2] -= param[0]
        K[1, 2] -= param[1]
    elif mode == "padding":
        K[0, 2] += param[0]
        K[1, 2] += param[1]
    else:
        raise ValueError(mode)
    return K


def make_calib(calib_file: str, base_dir: str, crop_params: Dict,
               dst_resolution: int) -> Dict:
    """Each camera's intrinsics after the pad, crop and resize
    (``crop_params``: {cam: [top, left, resolution, pad]}) and its 4x4
    extrinsics from the raw calibration ({cam: {K, R, T}}); writes
    ``base_dir/calib_{res}.json`` and returns its contents
    (fit_video_mv.py:627-669)."""
    with open(calib_file) as f:
        calib = json.loads(f.read())
    out = {"img_res": dst_resolution, "intrinsics": {}}
    for cam, (top, left, resolution, pad) in crop_params.items():
        K = np.asarray(calib[cam]["K"], np.float32).reshape(3, 3)
        K = adjust_intrinsic(K, "padding", (pad, pad))
        K = adjust_intrinsic(K, "crop", (left, top))
        s = dst_resolution / resolution
        K = adjust_intrinsic(K, "resize", (s, s))
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = np.asarray(calib[cam]["R"], np.float32).reshape(3, 3)
        T[:3, 3:] = np.asarray(calib[cam]["T"], np.float32).reshape(3, 1)
        out["intrinsics"][cam] = {"cam_K": K.reshape(-1).tolist(),
                                  "cam_T": T.reshape(-1).tolist()}
    path = os.path.join(base_dir, f"calib_{dst_resolution}.json")
    with open(path, "w") as f:
        f.write(json.dumps(out, indent=4))
    return out


def forward_landmarks_views(model: fv.FaceVerseModel, coeffs: torch.Tensor,
                            cam_Ts: torch.Tensor, cam_Ks: torch.Tensor,
                            cam_dist: float = 10.0) -> torch.Tensor:
    """[1, D] coefficients, V cameras (``cam_Ts`` [V, 4, 4], ``cam_Ks``
    [V, 3, 3]) -> projected landmarks [V, 478, 2]. A view's rotation is the
    head's right-multiplied by ``cam_T[:3, :3].T``; the head's translation
    goes through that rotation before ``cam_T[:3, 3]`` is added."""
    id_c, exp_c, _, angles, _, trans, eye_c, scale = fv.split_coeffs(
        coeffs, model.exp_dims)
    rot2 = cam_Ts[:, :3, :3].transpose(1, 2)                  # [V, 3, 3]
    rot = fv.euler_rotation(angles) @ rot2
    trans_v = (trans[:, None, :] @ rot2)[:, 0] + cam_Ts[:, :3, 3]
    vs = fv.get_vs(model, id_c, exp_c, eye_c)
    lms = fv.rigid_transform(vs[:, model.kp_inds], rot, trans_v, scale.abs())
    return fv.project_points(lms, cam_Ks[:, 0, 0, None], cam_Ks[:, 1, 1, None],
                             cam_Ks[:, 0, 2, None], cam_Ks[:, 1, 2, None],
                             cam_dist)


def forward_landmarks_view(model: fv.FaceVerseModel, coeffs: torch.Tensor,
                           cam_T: torch.Tensor, fx, fy, cx, cy,
                           cam_dist: float = 10.0) -> torch.Tensor:
    """One view of ``forward_landmarks_views``, in JAX's signature:
    [1, D] coefficients, ``cam_T`` [4, 4] -> [1, 478, 2]."""
    K = torch.tensor([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]],
                     dtype=torch.float32, device=cam_T.device)
    return forward_landmarks_views(model, coeffs, cam_T[None], K[None],
                                   cam_dist)


def make_fit_frame_mv(model: fv.FaceVerseModel, cam_Ks: np.ndarray,
                      cam_Ts: np.ndarray, cfg: fitting.FitConfig,
                      num_iters: int, first_frame: bool, fit_id: bool,
                      fit_scale: bool = True) -> Callable:
    """-> fit(state, gt_lms [V, 478, 2], valid [V], prev_rot, prev_trans)
    -> (state, losses [num_iters]) on the model's device; ``valid`` holds
    1.0 for a view with a face and 0.0 for one without. The loss is
    ``lm_loss_w`` times each valid view's landmark loss, summed and divided
    by max(sum(valid), 1), plus the exp and id regularisers and, after the
    first frame, the rot/trans smoothness (multiview.py:88-131)."""
    dev = model.device
    weights = fitting.landmark_weights(dev)
    Ks = torch.as_tensor(np.asarray(cam_Ks, np.float32), device=dev)
    Ts = torch.as_tensor(np.asarray(cam_Ts, np.float32), device=dev)
    names = fitting.trainable_names(fit_id, fit_scale)

    def fit(state: fitting.FitState, gt_lms: torch.Tensor,
            valid: torch.Tensor, prev_rot: torch.Tensor,
            prev_trans: torch.Tensor) -> Tuple[fitting.FitState, torch.Tensor]:
        gt = gt_lms.to(dev, torch.float32) / cfg.img_size
        valid = valid.to(dev, torch.float32)
        n_valid = valid.sum().clamp(min=1.0)

        def loss_fn(s: fitting.FitState) -> torch.Tensor:
            lms = forward_landmarks_views(model, fitting.pack(s), Ts, Ks,
                                          cfg.cam_dist)
            d = ((lms / cfg.img_size - gt) ** 2).sum(dim=-1)    # [V, 478]
            per_view = (d * weights).sum(dim=1)
            loss = cfg.lm_loss_w * (valid * per_view).sum() / n_valid
            loss = loss + cfg.exp_reg_w * (s.exp_c ** 2).sum()
            loss = loss + cfg.id_reg_w * (s.id_c ** 2).sum()
            if not first_frame:
                loss = loss + cfg.rt_reg_w * (
                    ((s.rot - prev_rot) ** 2).sum()
                    + ((s.trans - prev_trans) ** 2).sum())
            return loss

        return fitting.fit_loop(state, names, loss_fn, num_iters,
                                fitting.first_adam(first_frame))

    return fit
