"""Per-frame FaceVerse coefficient fitting: Adam on the landmark loss.

Port of ``havatar_tpu/preprocess/fitting.py`` (the reference's
data_preprocessing/fit_video.py:185-235). Adam runs over (exp, eye, rot,
trans [, id [, scale]]) with lr 1e-1, betas (0.8, 0.95) on the first frame
and 1e-2, (0.5, 0.9) on the others, where after 60% of the iterations a
second Adam (1e-3, (0.5, 0.9)), started from zero moments, takes over. The
loss is the eye-weighted MediaPipe landmark loss plus id/exp L2
regularisers plus, after the first frame, rot/trans smoothness against the
previous frame; negative expressions are clamped to 0 after each update.

JAX scans the iterations inside one jit and picks the optimizer with a
``where``; here the loop is a Python loop on the device, with no host sync
inside it: which optimizer runs and its step count are known on the host.
The trainables live in one flat vector, so an Adam update is a few
elementwise launches. The update is optax's, written out:
``m_hat / (sqrt(v_hat + eps_root) + eps)`` with eps 1e-8, eps_root 0, and
``1 - b ** count`` bias corrections.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from havatar_tpu_torch.device import DeviceLike, resolve_device
from havatar_tpu_torch.preprocess import faceverse as fv

# MediaPipe landmark weighting (the reference's core/utils.py:49-72)
_LIPS = [61, 146, 91, 181, 84, 17, 314, 405, 321, 375, 61, 185, 40, 39, 37, 0,
         267, 269, 270, 409, 78, 95, 88, 178, 87, 14, 317, 402, 318, 324, 78,
         191, 80, 81, 82, 13, 312, 311, 310, 415]
_L_EYE = [263, 249, 390, 373, 374, 380, 381, 382, 263, 466, 388, 387, 386,
          385, 384, 398]
_L_BROW = [276, 283, 282, 295, 300, 293, 334, 296]
_R_EYE = [33, 7, 163, 144, 145, 153, 154, 155, 33, 246, 161, 160, 159, 158,
          157, 173]
_R_BROW = [46, 53, 52, 65, 70, 63, 105, 66]

ADAM_EPS = 1e-8


def mediapipe_lm_weights() -> np.ndarray:
    w = np.ones(478, np.float32)
    w[_LIPS] = 5
    w[_L_EYE] = 50
    w[_R_EYE] = 50
    w[_L_BROW] = 5
    w[_R_BROW] = 5
    w[468:] = 5
    return w / w.sum()


def lm_loss(pred_lms, gt_lms, weights, img_size: int):
    d = ((pred_lms / img_size - gt_lms / img_size) ** 2).sum(dim=-1)
    return (d * weights.reshape(1, -1)).sum(dim=1).mean()


class FitConfig(NamedTuple):
    img_size: int = 512
    lm_loss_w: float = 1e3
    id_reg_w: float = 3e-3
    exp_reg_w: float = 1e-3
    rt_reg_w: float = 0.1
    cam_dist: float = 10.0


class FitState(NamedTuple):
    """A video's running coefficients, each [1, n]."""

    id_c: torch.Tensor      # [1, 150]
    exp_c: torch.Tensor     # [1, E]
    tex_c: torch.Tensor     # [1, 251]
    rot: torch.Tensor       # [1, 3]
    gamma: torch.Tensor     # [1, 27]
    trans: torch.Tensor     # [1, 3]
    eye: torch.Tensor       # [1, 4]
    scale: torch.Tensor     # [1, 1]


def init_fit_state(exp_dims: int, device: DeviceLike = None) -> FitState:
    dev = resolve_device(device)

    def zeros(n):
        return torch.zeros(1, n, device=dev)

    return FitState(id_c=zeros(fv.ID_DIMS), exp_c=zeros(exp_dims),
                    tex_c=zeros(fv.TEX_DIMS), rot=zeros(3), gamma=zeros(27),
                    trans=zeros(3), eye=zeros(4),
                    scale=torch.ones(1, 1, device=dev))


def pack(state: FitState) -> torch.Tensor:
    return fv.merge_coeffs(state.id_c, state.exp_c, state.tex_c, state.rot,
                           state.gamma, state.trans, state.eye, state.scale)


class Adam:
    """optax.adam(lr, b1, b2) on one flat float32 vector; ``step`` updates
    the vector in place and returns nothing (no host sync)."""

    def __init__(self, lr: float, b1: float, b2: float, like: torch.Tensor):
        self.lr, self.b1, self.b2 = lr, b1, b2
        self.mu = torch.zeros_like(like)
        self.nu = torch.zeros_like(like)
        self.count = 0

    def step(self, theta: torch.Tensor, g: torch.Tensor) -> None:
        self.count += 1
        self.mu = (1 - self.b1) * g + self.b1 * self.mu
        self.nu = (1 - self.b2) * (g * g) + self.b2 * self.nu
        # optax computes 1 - b ** count in float32
        bc1 = float(1 - np.float32(self.b1) ** np.float32(self.count))
        bc2 = float(1 - np.float32(self.b2) ** np.float32(self.count))
        mu_hat = self.mu / bc1
        nu_hat = self.nu / bc2
        theta.add_(mu_hat / (torch.sqrt(nu_hat) + ADAM_EPS) * (-self.lr))


def trainable_names(fit_id: bool, fit_scale: bool) -> Tuple[str, ...]:
    names = ("exp_c", "eye", "rot", "trans")
    if fit_id:
        names += ("id_c",) + (("scale",) if fit_scale else ())
    return names


def landmark_weights(device: DeviceLike = None) -> torch.Tensor:
    return torch.from_numpy(mediapipe_lm_weights()).to(resolve_device(device))


def fit_loss(model: fv.FaceVerseModel, s: FitState, gt_lms: torch.Tensor,
             prev_rot: torch.Tensor, prev_trans: torch.Tensor,
             cfg: FitConfig, intr4, weights: torch.Tensor,
             first_frame: bool) -> torch.Tensor:
    """The fit's loss at ``s``: the weighted landmark loss, the exp and id
    regularisers, and after the first frame the smoothness of rot and trans
    against the previous frame's."""
    fx, fy, cx, cy = [float(v) for v in intr4]
    lms_proj, _ = fv.forward_landmarks(model, pack(s), fx, fy, cx, cy,
                                       cfg.cam_dist)
    loss = cfg.lm_loss_w * lm_loss(lms_proj, gt_lms[None], weights,
                                   cfg.img_size)
    loss = loss + cfg.exp_reg_w * (s.exp_c ** 2).sum()
    loss = loss + cfg.id_reg_w * (s.id_c ** 2).sum()
    if not first_frame:
        loss = loss + cfg.rt_reg_w * (((s.rot - prev_rot) ** 2).sum()
                                      + ((s.trans - prev_trans) ** 2).sum())
    return loss


FINE_ADAM = (1e-3, 0.5, 0.9)       # a later frame's optimizer after 60%


def fit_loop(state: FitState, names: Sequence[str],
             loss_fn: Callable[[FitState], torch.Tensor], num_iters: int,
             adam: Tuple[float, float, float],
             fine: Optional[Tuple[float, float, float]] = None,
             fine_start: int = 0) -> Tuple[FitState, torch.Tensor]:
    """Adam (``adam``: lr, b1, b2) on the trainables ``names`` of ``state``
    against ``loss_fn``, with negative expressions clamped to 0 after each
    update (the reference's :232-233); with ``fine``, a second Adam from
    zero moments takes the iterations after ``fine_start``. Returns (state,
    losses [num_iters]): losses[i] is iteration i's loss before its
    update."""
    parts = [getattr(state, n) for n in names]
    shapes = [p.shape for p in parts]
    sizes = [p.numel() for p in parts]
    exp_lo = sum(sizes[:list(names).index("exp_c")])
    exp_hi = exp_lo + state.exp_c.numel()
    theta = torch.cat([p.reshape(-1) for p in parts]).float()
    coarse = Adam(*adam, theta)
    fine_opt = Adam(*fine, theta) if fine is not None else None
    losses = torch.empty(num_iters, device=theta.device)

    def unflatten(vec) -> Dict[str, torch.Tensor]:
        return {n: v.view(shp) for n, v, shp
                in zip(names, vec.split(sizes), shapes)}

    for i in range(num_iters):
        theta.requires_grad_(True)
        loss = loss_fn(state._replace(**unflatten(theta)))
        g, = torch.autograd.grad(loss, theta)
        theta = theta.detach()
        losses[i] = loss.detach()
        opt = fine_opt if (fine_opt is not None and i > fine_start) else coarse
        opt.step(theta, g)
        theta[exp_lo:exp_hi].clamp_(min=0.0)
    return state._replace(**unflatten(theta)), losses


def first_adam(first_frame: bool) -> Tuple[float, float, float]:
    """(lr, b1, b2) of the fit's first optimizer: frame 0's, or a later
    frame's."""
    return (1e-1, 0.8, 0.95) if first_frame else (1e-2, 0.5, 0.9)


def make_fit_frame(model: fv.FaceVerseModel, intr4, cfg: FitConfig,
                   num_iters: int, first_frame: bool, fit_id: bool,
                   fit_scale: bool = False) -> Callable:
    """-> fit(state, gt_lms [478, 2], prev_rot, prev_trans) -> (state,
    losses [num_iters]): losses[i] is iteration i's loss before its update
    (JAX's fit returns losses[-1]).

    ``first_frame`` selects the reference's frame-0 optimizer settings (and
    no fine optimizer, no smoothness term); the trainables are (exp, eye,
    rot, trans) plus (id [, scale]) when ``fit_id``."""
    weights = landmark_weights(model.device)
    names = trainable_names(fit_id, fit_scale)

    def fit(state: FitState, gt_lms: torch.Tensor, prev_rot: torch.Tensor,
            prev_trans: torch.Tensor) -> Tuple[FitState, torch.Tensor]:
        def loss_fn(s: FitState) -> torch.Tensor:
            return fit_loss(model, s, gt_lms, prev_rot, prev_trans, cfg,
                            intr4, weights, first_frame)

        return fit_loop(state, names, loss_fn, num_iters,
                        first_adam(first_frame),
                        None if first_frame else FINE_ADAM,
                        int(num_iters * 0.6))

    return fit


def head_transform_matrix(state: FitState,
                          no_scale: bool = True) -> torch.Tensor:
    """The fitted frame's 4x4 head transform P T (make_rotMat as used for
    metaFace_extr, fit_video.py:269-292)."""
    return fv.make_rot_mat(state.rot, state.trans, state.scale,
                           no_scale=no_scale)
