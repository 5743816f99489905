"""FaceVerse v3.1 3DMM as torch functions.

Port of ``havatar_tpu/preprocess/faceverse.py`` (the reference's
data_preprocessing/core/FaceVerseModel_v3.py): the PCA shape and texture
model (id 150, exp 52 or 171, tex 251), euler and per-eye rotations (both
returned transposed, for right-multiplication), the eyeballs' rotation about
their centres, vertex normals summed over the faces of ``point_buf``, SH
illumination, the rigid transform P (scale R) + t, the pinhole projection
through the renderer's x/z flip, and the packed coefficient vector of
``split_coeffs``.

The model asset (``faceverse_v3_1.npy``) is a download in the reference
too; ``load_model_dict`` applies the reference's load-time normalisation
(y/z flip, 0.1 scale, +1 y shift) and puts the model's tensors on the
device the caller names (the CUDA device when none is named).
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from havatar_tpu_torch.device import DeviceLike, resolve_device

ID_DIMS = 150
TEX_DIMS = 251


class FaceVerseModel(NamedTuple):
    """The model's tensors, on one device."""

    meanshape: torch.Tensor      # [1, 3V]
    meantex: torch.Tensor        # [1, 3V]
    id_base: torch.Tensor        # [3V, 150]
    exp_base: torch.Tensor       # [3V, E] (E = 52 or 171)
    tex_base: torch.Tensor       # [3V, 251]
    tri: torch.Tensor            # [F, 3] int64
    point_buf: torch.Tensor      # [V, K] faces adjacent to each vertex
    kp_inds: torch.Tensor        # [478] MediaPipe keypoint vertex ids
    ver_inds: Tuple[int, int, int]   # eyeball vertex ranges
    uv: Optional[torch.Tensor] = None

    @property
    def num_vertex(self) -> int:
        return self.meanshape.shape[1] // 3

    @property
    def exp_dims(self) -> int:
        return self.exp_base.shape[1]

    @property
    def device(self) -> torch.device:
        return self.meanshape.device


def load_model_dict(model_dict: Dict[str, Any],
                    exp_base_52: Optional[np.ndarray] = None,
                    device: DeviceLike = None) -> FaceVerseModel:
    """The model from the reference's .npy dict, with the reference's
    load-time normalisation (FaceVerseModel_v3.py:117-133)."""
    dev = resolve_device(device)
    meanshape = np.asarray(model_dict["meanshape"],
                           np.float32).reshape(-1, 3).copy()
    meanshape[:, [1, 2]] *= -1
    meanshape = meanshape * 0.1
    meanshape[:, 1] += 1

    id_base = np.asarray(model_dict["idBase"],
                         np.float32).reshape(-1, 3, ID_DIMS).copy()
    id_base[:, [1, 2]] *= -1
    id_base = (id_base * 0.1).reshape(-1, ID_DIMS)

    if exp_base_52 is not None:
        exp_base = np.asarray(exp_base_52, np.float32).reshape(-1, 3, 52).copy()
    else:
        exp_base = np.asarray(model_dict["exBase"],
                              np.float32).reshape(-1, 3, 171).copy()
    exp_base[:, [1, 2]] *= -1
    exp_base = (exp_base * 0.1).reshape(exp_base.shape[0] * 3, -1)

    def f32(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    def i64(a):
        return torch.from_numpy(np.asarray(a).astype(np.int64)).to(dev)

    return FaceVerseModel(
        meanshape=f32(meanshape.reshape(1, -1)),
        meantex=f32(np.asarray(model_dict["meantex"]).reshape(1, -1)),
        id_base=f32(id_base),
        exp_base=f32(exp_base),
        tex_base=f32(model_dict["texBase"]),
        tri=i64(model_dict["tri"]),
        point_buf=i64(model_dict["point_buf"]),
        kp_inds=i64(np.asarray(model_dict["mediapipe_keypoints"]).reshape(-1)),
        ver_inds=tuple(int(v) for v in model_dict["ver_inds"]),
        uv=f32(model_dict["uv"]) if "uv" in model_dict else None,
    )


def load_model_file(path: str, exp_52_path: Optional[str] = None,
                    device: DeviceLike = None) -> FaceVerseModel:
    model_dict = np.load(path, allow_pickle=True).item()
    exp52 = np.load(exp_52_path) if exp_52_path else None
    return load_model_dict(model_dict, exp52, device)


# ---------------------------------------------------------------------------
# coefficient packing (split_coeffs, FaceVerseModel_v3.py:219-229)
# ---------------------------------------------------------------------------

def split_coeffs(coeffs: torch.Tensor, exp_dims: int):
    """[B, 150+E+251+3+27+3+4(+1)] -> (id, exp, tex, angles, gamma, trans,
    eye, scale); scale is 1 when the vector has no scale column."""
    all_dims = ID_DIMS + exp_dims + TEX_DIMS
    id_c = coeffs[:, :ID_DIMS]
    exp_c = coeffs[:, ID_DIMS:ID_DIMS + exp_dims]
    tex_c = coeffs[:, ID_DIMS + exp_dims:all_dims]
    angles = coeffs[:, all_dims:all_dims + 3]
    gamma = coeffs[:, all_dims + 3:all_dims + 30]
    trans = coeffs[:, all_dims + 30:all_dims + 33]
    eye = coeffs[:, all_dims + 33:all_dims + 37]
    if coeffs.shape[1] == all_dims + 38:
        scale = coeffs[:, -1:]
    else:
        scale = torch.ones_like(coeffs[:, -1:])
    return id_c, exp_c, tex_c, angles, gamma, trans, eye, scale


def merge_coeffs(id_c, exp_c, tex_c, angles, gamma, trans, eye, scale):
    return torch.cat([id_c, exp_c, tex_c, angles, gamma, trans, eye, scale],
                     dim=1)


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------

def _rot_x(s, c, o, z):
    return torch.stack([o, z, z, z, c, -s, z, s, c], -1).reshape(-1, 3, 3)


def _rot_y(s, c, o, z):
    return torch.stack([c, z, s, z, o, z, -s, z, c], -1).reshape(-1, 3, 3)


def euler_rotation(angles: torch.Tensor) -> torch.Tensor:
    """[B, 3] XYZ euler angles -> [B, 3, 3] (Rz Ry Rx) transposed, for
    right-multiplication (FaceVerseModel_v3.py:415-445)."""
    sx, sy, sz = (torch.sin(angles[:, i]) for i in range(3))
    cx, cy, cz = (torch.cos(angles[:, i]) for i in range(3))
    o, z = torch.ones_like(sx), torch.zeros_like(sx)
    rz = torch.stack([cz, -sz, z, sz, cz, z, z, z, o], -1).reshape(-1, 3, 3)
    rot = rz @ _rot_y(sy, cy, o, z) @ _rot_x(sx, cx, o, z)
    return rot.transpose(1, 2)


def eye_rotation(eye2: torch.Tensor) -> torch.Tensor:
    """[B, 2] (pitch, yaw) -> [B, 3, 3] (Ry Rx) transposed
    (compute_eye_rotation_matrix, :384-411)."""
    sx, sy = torch.sin(eye2[:, 0]), torch.sin(eye2[:, 1])
    cx, cy = torch.cos(eye2[:, 0]), torch.cos(eye2[:, 1])
    o, z = torch.ones_like(sx), torch.zeros_like(sx)
    return (_rot_y(sy, cy, o, z) @ _rot_x(sx, cx, o, z)).transpose(1, 2)


def _identity_shape(model: FaceVerseModel, id_c) -> torch.Tensor:
    return id_c @ model.id_base.T + model.meanshape


def get_vs(model: FaceVerseModel, id_c, exp_c,
           eye_c: Optional[torch.Tensor] = None) -> torch.Tensor:
    """PCA shape, with the eyeballs rotated when ``eye_c`` is given ->
    [B, V, 3] (get_vs, :316-331)."""
    shape = id_c @ model.id_base.T + exp_c @ model.exp_base.T + model.meanshape
    vs = shape.reshape(id_c.shape[0], -1, 3)
    if eye_c is None:
        return vs
    v0, v1, v2 = model.ver_inds
    ident = _identity_shape(model, id_c).reshape(id_c.shape[0], -1, 3)
    l_mean, r_mean = _eye_center(ident, v0, v1), _eye_center(ident, v1, v2)
    l_part = (vs[:, v0:v1] - l_mean) @ eye_rotation(eye_c[:, :2]) + l_mean
    r_part = (vs[:, v1:v2] - r_mean) @ eye_rotation(eye_c[:, 2:]) + r_mean
    return torch.cat([vs[:, :v0], l_part, r_part, vs[:, v2:]], dim=1)


def _eye_center(ident_vs: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """The eyeball's mean vertex on the identity shape, its z moved by
    +0.005."""
    eye = ident_vs[:, lo:hi]
    return torch.cat([eye[..., :2], eye[..., 2:] + 0.005],
                     dim=-1).mean(dim=1, keepdim=True)


def get_color(model: FaceVerseModel, tex_c) -> torch.Tensor:
    tex = tex_c @ model.tex_base.T + model.meantex
    return tex.reshape(tex_c.shape[0], -1, 3)


def compute_normals(model: FaceVerseModel, vs: torch.Tensor) -> torch.Tensor:
    """Vertex normals: the unnormalised normals of the faces in each
    vertex's ``point_buf`` row, summed and normalised (compute_norm,
    :350-363)."""
    tri = model.tri
    v1, v2, v3 = vs[:, tri[:, 0]], vs[:, tri[:, 1]], vs[:, tri[:, 2]]
    face_n = torch.linalg.cross(v1 - v2, v2 - v3, dim=-1)
    vn = face_n[:, model.point_buf].sum(dim=2)
    return vn / (torch.linalg.norm(vn, dim=2, keepdim=True) + 1e-9)


def rigid_transform(vs, rot, trans, scale):
    """P (scale) R + t (rigid_transform, :480-483)."""
    return (vs * scale[..., None]) @ rot + trans[:, None, :]


def sh_illumination(face_texture: torch.Tensor, norm: torch.Tensor,
                    gamma: torch.Tensor) -> torch.Tensor:
    """Second-order SH lighting (add_illumination, :448-478)."""
    g = gamma.reshape(-1, 3, 9)
    g = torch.cat([g[:, :, :1] + 0.8, g[:, :, 1:]], dim=2).transpose(1, 2)

    a0, a1, a2 = np.pi, 2 * np.pi / np.sqrt(3.0), 2 * np.pi / np.sqrt(8.0)
    c0 = 1 / np.sqrt(4 * np.pi)
    c1 = np.sqrt(3.0) / np.sqrt(4 * np.pi)
    c2 = 3 * np.sqrt(5.0) / np.sqrt(12 * np.pi)
    d0 = 0.5 / np.sqrt(3.0)

    nx, ny, nz = norm[..., 0], norm[..., 1], norm[..., 2]
    H = torch.stack([
        a0 * c0 * torch.ones_like(nx),
        -a1 * c1 * ny,
        a1 * c1 * nz,
        -a1 * c1 * nx,
        a2 * c2 * nx * ny,
        -a2 * c2 * ny * nz,
        a2 * c2 * d0 * (3 * nz ** 2 - 1),
        -a2 * c2 * nx * nz,
        a2 * c2 * 0.5 * (nx ** 2 - ny ** 2),
    ], dim=-1)                                           # [B, V, 9]
    return face_texture * (H @ g)


def project_points(vs: torch.Tensor, fx, fy, cx, cy,
                   cam_dist: float = 10.0) -> torch.Tensor:
    """Pinhole projection after the renderer's flip of x and z and the
    camera shift (ModelRenderer.project_vs / _get_reverse_xz, :604-617):
    image x = cx + fx (-x) / (cam_dist - z)."""
    depth = cam_dist - vs[..., 2]
    x = fx * -vs[..., 0] / depth + cx
    y = fy * vs[..., 1] / depth + cy
    return torch.stack([x, y], dim=-1)


def forward_landmarks(model: FaceVerseModel, coeffs: torch.Tensor,
                      fx, fy, cx, cy, cam_dist: float = 10.0):
    """coeffs -> (projected MediaPipe landmarks [B, 478, 2], world
    landmarks): the fitting's forward (render=False, :293-297)."""
    id_c, exp_c, _, angles, _, trans, eye_c, scale = split_coeffs(
        coeffs, model.exp_dims)
    vs = get_vs(model, id_c, exp_c, eye_c)
    vs_t = rigid_transform(vs, euler_rotation(angles), trans, scale.abs())
    lms_t = vs_t[:, model.kp_inds]
    return project_points(lms_t, fx, fy, cx, cy, cam_dist), lms_t


def make_rot_mat(angles, translation, scale,
                 no_scale: bool = False) -> torch.Tensor:
    """4x4 row-vector transform P T (make_rotMat, :372-381)."""
    rot = euler_rotation(angles)[0]
    top = rot if no_scale else scale[0].abs() * rot
    T = torch.eye(4, dtype=torch.float32, device=rot.device)
    T[:3, :3] = top
    T[3, :3] = translation[0]
    return T
