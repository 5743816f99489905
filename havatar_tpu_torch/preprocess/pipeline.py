"""Offline preprocessing: per-frame assets and the training split.

Port of ``havatar_tpu/preprocess/pipeline.py`` (the reference's
data_preprocessing/fit_video.py): the three orthographic condition renders
of a fitted frame (:316-339), its ``coeffs.npy`` / ``metaFace_extr.npz`` /
``finish`` files (:269-307), and the split writers ``make_transform``
(:342-418), ``make_animation_transform`` (:421-477) and
``filter_selected_transform`` (:479-509), with the reference's on-disk
layout and field names, so that the split loads through
``data/dataset.py:AvatarDataset``. The renders run on the device of the
vertices; the split writers are host numpy and json, the JAX package's code.
"""

from __future__ import annotations

import json
import os
import random
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from havatar_tpu_torch.device import DeviceLike, resolve_device
from havatar_tpu_torch.ops.boxwarp import BoxWarp
from havatar_tpu_torch.preprocess import faceverse as fv
from havatar_tpu_torch.preprocess.rasterizer import render_ortho_condition

# the ortho condition cameras: K = (-1, -1, 0, 0); front, left and right
# views turned 0, -90 and +90 degrees about y
ORTHO_K = (-1.0, -1.0, 0.0, 0.0)
CANONICAL_BOUNDS = ((-1.5, 1.5), (-1.6, 1.4), (-1.6, 1.2))


def ortho_view_rotations(device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """The three views' rotations, transposed for right-multiplication (as
    ``faceverse.euler_rotation``'s are), on ``device`` (default: the CUDA
    device; raises without one)."""
    device = resolve_device(device)

    def roty(deg):
        a = np.deg2rad(deg)
        r = np.asarray([[np.cos(a), 0, np.sin(a)],
                        [0, 1, 0],
                        [-np.sin(a), 0, np.cos(a)]], np.float32)
        return torch.from_numpy(np.ascontiguousarray(r.T)).to(device)

    return {"front": roty(0.0), "left": roty(-90.0), "right": roty(90.0)}


def render_condition_set(model: fv.FaceVerseModel, vs: torch.Tensor,
                         colors: torch.Tensor, out_dir: str,
                         res: int = 256) -> None:
    """Render and save the three ortho condition images and normals of one
    frame (render_canonical_ortho, fit_video.py:316-339): canonical
    vertices ``vs`` [V, 3] box-warped to the sampling cube, vertex colours
    [V, 3]. The PNGs take the values truncated to uint8, as the reference's
    ``astype`` does."""
    import cv2

    verts = BoxWarp.from_bounds(CANONICAL_BOUNDS)(vs)
    os.makedirs(out_dir, exist_ok=True)
    for name, rot in ortho_view_rotations(vs.device).items():
        img, normal = render_ortho_condition(verts, model.tri, colors, rot,
                                             ORTHO_K, res)
        cv2.imwrite(os.path.join(out_dir,
                                 f"ortho_{name}_render_256_baseGama.png"),
                    cv2.cvtColor(img.cpu().numpy().astype(np.uint8),
                                 cv2.COLOR_RGB2BGR))
        cv2.imwrite(os.path.join(out_dir,
                                 f"ortho_{name}_normal_256_baseGama.png"),
                    normal.cpu().numpy().astype(np.uint8))


def save_frame_assets(save_dir: str, frame_name: str, coeffs: np.ndarray,
                      head_T: np.ndarray, extr: np.ndarray,
                      transformation: np.ndarray,
                      self_rotation: Optional[np.ndarray] = None) -> None:
    """coeffs.npy + metaFace_extr.npz + finish marker
    (spec: fit_video.py:269-307)."""
    d = os.path.join(save_dir, frame_name)
    os.makedirs(d, exist_ok=True)
    np.save(os.path.join(d, "coeffs.npy"), np.asarray(coeffs))
    np.savez(os.path.join(d, "metaFace_extr.npz"),
             head_T=np.asarray(head_T, np.float32),
             extr=np.asarray(extr, np.float32),
             transformation=np.asarray(transformation, np.float32),
             self_rotation=(np.asarray(self_rotation, np.float32)
                            if self_rotation is not None else np.eye(3, dtype=np.float32)))
    open(os.path.join(d, "finish"), "w").close()


def save_fitted_frame(model: fv.FaceVerseModel, coeffs: torch.Tensor,
                      save_dir: str, frame_name: str,
                      render: bool = True) -> None:
    """A fitted frame's files from its [1, D] coefficients:
    ``save_frame_assets`` with the head transform P T without and with the
    scale (make_rotMat, fit_video.py:269-292) and, with ``render``, the
    three ortho condition renders (fit_video.py:316-339)."""
    id_c, exp_c, tex_c, angles, _, trans, eye_c, scale = fv.split_coeffs(
        coeffs, model.exp_dims)
    head_T = fv.make_rot_mat(angles, trans, scale, no_scale=True)
    extr = fv.make_rot_mat(angles, trans, scale, no_scale=False).cpu().numpy()
    save_frame_assets(save_dir, frame_name, coeffs[0].cpu().numpy(),
                      head_T=head_T.cpu().numpy(), extr=extr,
                      transformation=extr)
    if render:
        render_condition_set(model, fv.get_vs(model, id_c, exp_c, eye_c)[0],
                             fv.get_color(model, tex_c)[0],
                             os.path.join(save_dir, frame_name))


def rotate_by_theta_along_y(theta: float) -> np.ndarray:
    t = np.eye(4, dtype=np.float32)
    t[0, 0] = t[2, 2] = np.cos(theta)
    t[0, 2] = -np.sin(theta)
    t[2, 0] = -t[0, 2]
    return t


def make_transform(base_dir: str, save_dir: str, calib: Dict,
                   valid_view_name: Sequence[str], base_zero_frameind: str,
                   shuffle: bool = True, seed: Optional[int] = None) -> str:
    """Assemble the training split JSON (spec: fit_video.py:342-418).

    Frame 10 (``base_zero_frameind``) defines the zero pose;
    head_transformation = (head_T · head_T0^-1)^T; camera matrices are
    composed through mesh->global transforms.
    """
    img_res = calib["img_res"]
    mv_mask_dir = os.path.join(base_dir, f"mv_mask{img_res}")
    mv_img_dir = os.path.join(base_dir, f"mv_rgb{img_res}")
    mv_bg_dir = os.path.join(base_dir, f"mv_bg{img_res}")

    views = []
    for name in valid_view_name:
        views.append({
            "view_name": name,
            "cam_K": np.asarray(calib["intrinsics"][name]["cam_K"],
                                np.float32).reshape(3, 3),
            "cam_T": np.asarray(calib["intrinsics"][name]["cam_T"],
                                np.float32).reshape(4, 4),
        })

    data: Dict = {"img_res": img_res}
    data["mutiview_intr_ls"] = [
        [float(v["cam_K"][0, 0]), float(v["cam_K"][1, 1]),
         float(v["cam_K"][0, 2] / img_res), float(v["cam_K"][1, 2] / img_res)]
        for v in views
    ]
    if os.path.isdir(mv_bg_dir):
        data["bg_path"] = [os.path.join(mv_bg_dir, f"{v}.png")
                           for v in valid_view_name]
    data["init_model_coeffs_path"] = os.path.join(
        save_dir, base_zero_frameind, "coeffs.npy")
    data["base_frontal_mask_path"] = os.path.join(
        mv_mask_dir, valid_view_name[0], base_zero_frameind + ".png")

    base = np.load(os.path.join(save_dir, base_zero_frameind,
                                "metaFace_extr.npz"))
    head_T0 = base["head_T"].astype(np.float32)
    transformation0 = base["transformation"].astype(np.float32)
    cam_T0 = views[0]["cam_T"]
    mesh2glo = np.linalg.inv(cam_T0) @ transformation0

    frames: List[Dict] = []
    for frame_name in os.listdir(os.path.join(mv_img_dir, valid_view_name[0])):
        fidx = int(frame_name.split(".")[0])
        if fidx < int(base_zero_frameind):
            continue
        inst = os.path.join(save_dir, frame_name.split(".")[0])
        if not os.path.exists(os.path.join(inst, "finish")):
            continue
        extr = np.load(os.path.join(inst, "metaFace_extr.npz"))
        head_T = extr["head_T"].astype(np.float32)
        mesh2glo_ori = np.linalg.inv(cam_T0) @ extr["transformation"].astype(np.float32)

        frame: Dict = {
            "fidx": fidx,
            "inst_dir": inst,
            "head_transformation": (head_T @ np.linalg.inv(head_T0)).T.tolist(),
        }
        mv = []
        for v in views:
            cam2mesh = np.linalg.inv(v["cam_T"] @ mesh2glo)
            cam2mesh_ori = np.linalg.inv(v["cam_T"] @ mesh2glo_ori)
            mv.append({
                "view_name": v["view_name"],
                "mask_path": os.path.join(mv_mask_dir, v["view_name"], frame_name),
                "file_path": os.path.join(mv_img_dir, v["view_name"], frame_name),
                "transform_matrix": cam2mesh.tolist(),
                "transform_matrix_ori": cam2mesh_ori.tolist(),
            })
        frame["mutiview_info_ls"] = mv
        frames.append(frame)

    frames.sort(key=lambda x: x["fidx"])
    if shuffle:
        random.Random(seed).shuffle(frames)
    data["frames"] = frames

    prefix = "sv" if len(valid_view_name) == 1 else "mv"
    out_path = os.path.join(base_dir, f"{prefix}_v31_all.json")
    with open(out_path, "w") as f:
        f.write(json.dumps(data, indent=4))
    return out_path


def make_animation_transform(drive_base_dir: str, drive_save_dir: str,
                             calib: Dict, drive_zeropose_frameind: str,
                             cam_K: np.ndarray, avatar_baseframe_path: str,
                             drive_dir_name: str, view_num: int = 1) -> str:
    """Cross-reenactment drive split (spec: fit_video.py:421-477): reuse the
    avatar's base extrinsics, optionally a y-rotation freeview ring."""
    img_res = calib["img_res"]
    cam_K = np.asarray(cam_K, np.float32).reshape(3, 3)
    data: Dict = {
        "img_res": img_res,
        "init_model_coeffs_path": os.path.join(avatar_baseframe_path, "coeffs.npy"),
        "mutiview_intr_ls": [
            [float(cam_K[0, 0]), float(cam_K[1, 1]),
             float(cam_K[0, 2] / img_res), float(cam_K[1, 2] / img_res)]
            for _ in range(view_num)
        ],
    }

    avatar_base = np.load(os.path.join(avatar_baseframe_path, "metaFace_extr.npz"))
    model0_T_ori = avatar_base["transformation"].astype(np.float32)
    drive_base = np.load(os.path.join(drive_save_dir, drive_zeropose_frameind,
                                      "metaFace_extr.npz"))
    drive_head_T0 = drive_base["head_T"].astype(np.float32)
    drive_T0_ori = drive_base["transformation"].astype(np.float32)

    frames: List[Dict] = []
    for fidx in os.listdir(drive_save_dir):
        fdir = os.path.join(drive_save_dir, fidx)
        if not os.path.exists(os.path.join(fdir, "finish")):
            continue
        if not os.path.exists(os.path.join(fdir, drive_dir_name)):
            continue
        extr = np.load(os.path.join(fdir, "metaFace_extr.npz"))
        head_T = extr["head_T"].astype(np.float32)
        model_T_ori = (np.linalg.inv(drive_T0_ori)
                       @ extr["transformation"].astype(np.float32))
        frame: Dict = {
            "fidx": int(fidx),
            "inst_dir": os.path.join(fdir, drive_dir_name),
            "head_transformation":
                (head_T @ np.linalg.inv(drive_head_T0)).T.tolist(),
        }
        view_range = [0] if view_num == 1 else list(range(-30, 30, 60 // view_num))
        mv = []
        for vidx, angle in enumerate(view_range):
            rot = rotate_by_theta_along_y(angle / 180 * np.pi)
            mesh2cam = model0_T_ori @ rot
            mv.append({
                "view_name": str(vidx),
                "transform_matrix": np.linalg.inv(mesh2cam).tolist(),
                "transform_matrix_ori":
                    np.linalg.inv(model0_T_ori @ (rot @ model_T_ori)).tolist(),
            })
        frame["mutiview_info_ls"] = mv
        frames.append(frame)

    frames.sort(key=lambda x: x["fidx"])
    data["frames"] = frames
    json_name = f"drive_{drive_dir_name}" + ("_freeview" if view_num > 1 else "")
    out_path = os.path.join(drive_base_dir, json_name + ".json")
    with open(out_path, "w") as f:
        f.write(json.dumps(data, indent=4))
    if view_num > 1:
        filter_selected_transform(out_path)
    return out_path


def filter_selected_transform(transform_split_path: str, init: int = 0) -> str:
    """Sweep the freeview ring over frames (spec: fit_video.py:479-509)."""
    import copy

    save_path = transform_split_path.split(".")[0] + "_selected.json"
    all_t = json.loads(open(transform_split_path).read())
    dst = copy.deepcopy(all_t)
    frames = all_t["frames"]
    frames.sort(key=lambda x: x["fidx"])
    count = init
    view_num = len(frames[0]["mutiview_info_ls"])
    for idx, frame in enumerate(frames):
        vidx = count % (view_num * 2)
        vidx = view_num - 1 - count % view_num if vidx >= view_num else count % view_num
        keep = {str(view_num // 2), str(vidx)}
        dst["frames"][idx]["mutiview_info_ls"] = [
            mv for mv in frame["mutiview_info_ls"] if mv["view_name"] in keep
        ]
        count += 1
    with open(save_path, "w") as f:
        f.write(json.dumps(dst, indent=4))
    return save_path
