"""havatar_tpu_torch/preprocess against havatar_tpu/preprocess, on the CPU.

The FaceVerse functions on a random model dict in the reference's layout
(tests/test_faceverse_oracle.py's, 171 expressions, eyeball ranges), at that
file's bounds (atol 1e-5 to 2e-5); the fitting's loss and its gradient at a
seeded state (rtol 1e-4 of the largest entry), one hand-written Adam step
against optax (atol 1e-7), and 10-iteration fits of a first frame and of a
later frame whose fine optimizer takes over after iteration 6, on a
well-conditioned seeded model: projected landmarks atol 1e-3 px, loss rtol
1e-4. The rasterizer on a small sphere at 64^2: depth atol 1e-5 where both
hit, hit masks equal but for at most 2 pixels that lie within 1e-6 of a
face's edge, image atol 1e-3; ``depth2normal_ortho`` atol 1e-5. The split
writers, the video crop, and the precomputed and threshold backends give
the same files and arrays as the JAX package's.

Inputs from numpy RandomState; float32; JAX jitted on the CPU.
"""

import json
import os

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from havatar_tpu.preprocess import faceverse as JFV
from havatar_tpu.preprocess import fitting as JFIT
from havatar_tpu.preprocess import landmarks as JLM
from havatar_tpu.preprocess import matting as JMAT
from havatar_tpu.preprocess import pipeline as JP
from havatar_tpu.preprocess import rasterizer as JRAS
from havatar_tpu.preprocess import video as JV
from havatar_tpu_torch.preprocess import faceverse as TFV
from havatar_tpu_torch.preprocess import fitting as TFIT
from havatar_tpu_torch.preprocess import landmarks as TLM
from havatar_tpu_torch.preprocess import matting as TMAT
from havatar_tpu_torch.preprocess import pipeline as TP
from havatar_tpu_torch.preprocess import rasterizer as TRAS
from havatar_tpu_torch.preprocess import video as TV

from test_faceverse_oracle import COEFF_DIM, _model_dict


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(got, want, atol, rtol=0.0):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=rtol)


@pytest.fixture(scope="module")
def models():
    md = _model_dict(np.random.RandomState(0))
    return JFV.load_model_dict(md), TFV.load_model_dict(md, device="cpu"), md


def _coeffs(seed, scale_col=True):
    rng = np.random.RandomState(seed)
    c = (rng.randn(1, COEFF_DIM) * 0.3).astype(np.float32)
    if not scale_col:
        return c[:, :-1]
    c[:, -1] = 1.0 + 0.1 * rng.randn()
    return c


def test_load_and_split_merge(models):
    j, t, md = models
    for name in ("meanshape", "meantex", "id_base", "exp_base", "tex_base"):
        _close(getattr(t, name), getattr(j, name), atol=0)
    for name in ("tri", "point_buf", "kp_inds"):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)))
    assert t.ver_inds == j.ver_inds and t.exp_dims == j.exp_dims == 171
    exp52 = np.random.RandomState(1).randn(t.num_vertex * 3, 52)
    assert TFV.load_model_dict(md, exp52, device="cpu").exp_dims == 52
    for scale_col in (True, False):
        c = _coeffs(2, scale_col)
        parts_t = TFV.split_coeffs(_t(c), 171)
        parts_j = JFV.split_coeffs(jnp.asarray(c), 171)
        for a, b in zip(parts_t, parts_j):
            _close(a, b, atol=0)
        if scale_col:
            _close(TFV.merge_coeffs(*parts_t), c, atol=0)


def test_rotations_vertices_colour_normals_lighting(models):
    j, t, _ = models
    c = _coeffs(3)
    cj, ct = jnp.asarray(c), _t(c)
    id_t, exp_t, tex_t, ang_t, gam_t, _, eye_t, _ = TFV.split_coeffs(ct, 171)
    id_j, exp_j, tex_j, ang_j, gam_j, _, eye_j, _ = JFV.split_coeffs(cj, 171)
    _close(TFV.euler_rotation(ang_t), JFV.euler_rotation(ang_j), atol=1e-6)
    _close(TFV.eye_rotation(eye_t[:, 2:]), JFV.eye_rotation(eye_j[:, 2:]),
           atol=1e-6)
    vs_t = TFV.get_vs(t, id_t, exp_t, eye_t)
    vs_j = JFV.get_vs(j, id_j, exp_j, eye_j)
    _close(vs_t, vs_j, atol=2e-5)
    _close(TFV.get_vs(t, id_t, exp_t), JFV.get_vs(j, id_j, exp_j), atol=2e-5)
    tex_want = JFV.get_color(j, tex_j)
    _close(TFV.get_color(t, tex_t), tex_want, atol=2e-5)
    n_want = JFV.compute_normals(j, jnp.asarray(vs_t.numpy()))
    n_got = TFV.compute_normals(t, vs_t)
    _close(n_got, n_want, atol=1e-5)
    _close(TFV.sh_illumination(_t(tex_want), n_got, gam_t),
           JFV.sh_illumination(tex_want, jnp.asarray(n_got.numpy()), gam_j),
           atol=1e-5, rtol=1e-5)


def test_rigid_projection_landmarks_rot_mat(models):
    j, t, _ = models
    rng = np.random.RandomState(4)
    vs = rng.randn(1, 64, 3).astype(np.float32)
    rot = np.asarray(JFV.euler_rotation(jnp.asarray([[0.1, 0.5, -0.2]])))
    trans = np.asarray([[0.2, -0.1, 0.3]], np.float32)
    scale = np.asarray([[1.07]], np.float32)
    want = JFV.rigid_transform(jnp.asarray(vs), jnp.asarray(rot),
                               jnp.asarray(trans), jnp.asarray(scale))
    got = TFV.rigid_transform(_t(vs), _t(rot), _t(trans), _t(scale))
    _close(got, want, atol=1e-6)
    _close(TFV.project_points(got, 1315.0, 1315.0, 128.0, 128.0),
           JFV.project_points(want, 1315.0, 1315.0, 128.0, 128.0), atol=1e-3)
    for scale_col in (True, False):
        c = _coeffs(5, scale_col)
        got_p, got_w = TFV.forward_landmarks(t, _t(c), 1315.0, 1315.0, 128.0,
                                             128.0)
        want_p, want_w = JFV.forward_landmarks(j, jnp.asarray(c), 1315.0,
                                               1315.0, 128.0, 128.0)
        _close(got_w, want_w, atol=2e-5)
        _close(got_p, want_p, atol=2e-3)
    ang, tr, sc = (np.asarray([[0.3, -0.2, 0.9]], np.float32),
                   np.asarray([[0.5, 0.1, -0.4]], np.float32),
                   np.asarray([[-1.2]], np.float32))
    for no_scale in (False, True):
        _close(TFV.make_rot_mat(_t(ang), _t(tr), _t(sc), no_scale),
               JFV.make_rot_mat(jnp.asarray(ang), jnp.asarray(tr),
                                jnp.asarray(sc), no_scale), atol=1e-6)


# ---------------------------------------------------------------------------
# fitting
# ---------------------------------------------------------------------------

INTR = np.asarray([500.0, 500.0, 128.0, 128.0], np.float32)
FIT_CFG = dict(img_size=256)


def _fit_model_dict(V=600):
    """A well-conditioned model: a spread-out mean head, bases that move
    every landmark, the 478 landmarks on distinct vertices, the last ten on
    the eyeballs."""
    rng = np.random.RandomState(7)
    v0, v1 = V - 40, V - 20
    kp = rng.choice(v0, 468, replace=False)
    kp = np.concatenate([kp, rng.choice(np.arange(v1, V), 5, replace=False),
                         rng.choice(np.arange(v0, v1), 5, replace=False)])
    return {
        "meanshape": (rng.randn(V * 3) * 4.0).astype(np.float32),
        "meantex": (rng.rand(V * 3) * 200 + 20).astype(np.float32),
        "idBase": (rng.randn(V * 3, 150) * 0.05).astype(np.float32),
        "exBase": (rng.randn(V * 3, 171) * 0.05).astype(np.float32),
        "texBase": (rng.randn(V * 3, 251) * 0.01).astype(np.float32),
        "tri": rng.randint(0, V, (200, 3)).astype(np.int64),
        "point_buf": rng.randint(0, 200, (V, 8)).astype(np.int64),
        "mediapipe_keypoints": kp.astype(np.int64),
        "ver_inds": np.asarray([v0, v1, V]),
    }


@pytest.fixture(scope="module")
def fit_models():
    md = _fit_model_dict()
    j, t = JFV.load_model_dict(md), TFV.load_model_dict(md, device="cpu")
    rng = np.random.RandomState(8)
    true = np.zeros((1, COEFF_DIM - 1), np.float32)
    true[0, :150] = rng.randn(150) * 0.5
    true[0, 150:321] = np.abs(rng.randn(171)) * 0.5
    a = 150 + 171 + 251
    true[0, a:a + 3] = [0.15, -0.2, 0.05]
    true[0, a + 30:a + 33] = [0.1, -0.05, 0.2]
    true[0, a + 33:a + 37] = [0.05, -0.1, 0.02, 0.08]
    gt, _ = JFV.forward_landmarks(j, jnp.asarray(true), *INTR)
    gt = np.asarray(gt)[0] + rng.randn(478, 2).astype(np.float32) * 0.5
    return j, t, gt.astype(np.float32)


def _start_state(rng, exp_dims=171):
    """A state near the answer, with every coefficient nonzero."""
    vals = {"id_c": rng.randn(1, 150) * 0.3,
            "exp_c": np.abs(rng.randn(1, exp_dims)) * 0.3,
            "tex_c": rng.randn(1, 251) * 0.1, "rot": rng.randn(1, 3) * 0.1,
            "gamma": rng.randn(1, 27) * 0.1, "trans": rng.randn(1, 3) * 0.1,
            "eye": rng.randn(1, 4) * 0.05, "scale": np.ones((1, 1))}
    vals = {k: v.astype(np.float32) for k, v in vals.items()}
    return (JFIT.FitState(**{k: jnp.asarray(v) for k, v in vals.items()}),
            TFIT.FitState(**{k: _t(v) for k, v in vals.items()}))


def _jax_loss(model, cfg, first_frame, names):
    """havatar_tpu.preprocess.fitting's loss, from its public pieces."""
    weights = jnp.asarray(JFIT.mediapipe_lm_weights())

    def loss(tr, state, gt, prev_rot, prev_trans):
        s = state._replace(**tr)
        p, _ = JFV.forward_landmarks(model, JFIT.pack(s), *INTR)
        out = cfg.lm_loss_w * JFIT.lm_loss(p, gt[None], weights, cfg.img_size)
        out = out + cfg.exp_reg_w * jnp.sum(jnp.square(s.exp_c))
        out = out + cfg.id_reg_w * jnp.sum(jnp.square(s.id_c))
        if not first_frame:
            out = out + cfg.rt_reg_w * (
                jnp.sum(jnp.square(s.rot - prev_rot))
                + jnp.sum(jnp.square(s.trans - prev_trans)))
        return out

    return jax.jit(jax.value_and_grad(loss))


@pytest.mark.parametrize("first_frame", [True, False])
def test_fit_loss_and_gradient_match_jax(fit_models, first_frame):
    j, t, gt = fit_models
    sj, st = _start_state(np.random.RandomState(9))
    prev = np.asarray([[0.1, -0.1, 0.05]], np.float32)
    names = ("exp_c", "eye", "rot", "trans", "id_c")
    cfg_j, cfg_t = JFIT.FitConfig(**FIT_CFG), TFIT.FitConfig(**FIT_CFG)
    want, wgrads = _jax_loss(j, cfg_j, first_frame, names)(
        {n: getattr(sj, n) for n in names}, sj, jnp.asarray(gt),
        jnp.asarray(prev), jnp.asarray(prev * 2))
    leaves = {n: getattr(st, n).clone().requires_grad_(True) for n in names}
    got = TFIT.fit_loss(t, st._replace(**leaves), _t(gt), _t(prev),
                        _t(prev * 2), cfg_t, INTR,
                        TFIT.landmark_weights(t.device), first_frame)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-4)
    for n in names:
        w = np.asarray(wgrads[n])
        np.testing.assert_allclose(leaves[n].grad.numpy(), w,
                                   atol=1e-4 * np.abs(w).max(), err_msg=n)


def test_adam_step_matches_optax():
    """Three steps of the hand-written Adam against optax.adam on the same
    gradients, at both of the fit's settings: atol 1e-7."""
    rng = np.random.RandomState(10)
    theta = rng.randn(300).astype(np.float32)
    for lr, b1, b2 in ((1e-1, 0.8, 0.95), (1e-3, 0.5, 0.9)):
        opt = optax.adam(lr, b1=b1, b2=b2)
        pj, sj = jnp.asarray(theta), opt.init(jnp.asarray(theta))
        pt = _t(theta)
        adam = TFIT.Adam(lr, b1, b2, pt)
        for _ in range(3):
            g = (rng.randn(300) * 10.0 ** rng.uniform(-6, 1, 300)).astype(
                np.float32)
            up, sj = opt.update(jnp.asarray(g), sj, pj)
            pj = optax.apply_updates(pj, up)
            adam.step(pt, _t(g))
            _close(pt, pj, atol=1e-7)


@pytest.mark.parametrize("first_frame,fit_id", [(True, True), (False, False)])
def test_ten_iteration_fit_matches_jax(fit_models, first_frame, fit_id):
    """10 iterations: a first frame (lr 1e-1, the identity fitted) and a
    later frame (lr 1e-2, then from iteration 7 the fine Adam from zero
    moments, smoothness against the previous pose). Projected landmarks of
    the result atol 1e-3 px, the last iteration's loss rtol 1e-4."""
    j, t, gt = fit_models
    sj, st = _start_state(np.random.RandomState(11))
    prev = np.asarray([[0.12, -0.18, 0.04]], np.float32)
    prev_t = np.asarray([[0.1, -0.05, 0.19]], np.float32)
    fj = JFIT.make_fit_frame(j, INTR, JFIT.FitConfig(**FIT_CFG), 10,
                             first_frame=first_frame, fit_id=fit_id)
    ft = TFIT.make_fit_frame(t, INTR, TFIT.FitConfig(**FIT_CFG), 10,
                             first_frame=first_frame, fit_id=fit_id)
    sj2, loss_j = fj(sj, jnp.asarray(gt), jnp.asarray(prev),
                     jnp.asarray(prev_t))
    st2, losses = ft(st, _t(gt), _t(prev), _t(prev_t))
    assert losses.shape == (10,) and float(losses[-1]) < float(losses[0])
    np.testing.assert_allclose(float(losses[-1]), float(loss_j), rtol=1e-4)
    want, _ = JFV.forward_landmarks(j, JFIT.pack(sj2), *INTR)
    got, _ = TFV.forward_landmarks(t, TFIT.pack(st2), *INTR)
    _close(got, want, atol=1e-3)
    assert float(st2.exp_c.min()) >= 0.0
    np.testing.assert_array_equal(st2.tex_c.numpy(), st.tex_c.numpy())
    if not fit_id:
        np.testing.assert_array_equal(st2.id_c.numpy(), st.id_c.numpy())
    for no_scale in (True, False):
        _close(TFIT.head_transform_matrix(st2, no_scale),
               JFIT.head_transform_matrix(sj2, no_scale), atol=1e-4)


# ---------------------------------------------------------------------------
# rasterizer
# ---------------------------------------------------------------------------

def _sphere(n_lat=12, n_lon=16, r=0.7):
    """A closed UV sphere: [V, 3] vertices, [F, 3] faces."""
    verts = [[0.0, r, 0.0]]
    for i in range(1, n_lat):
        th = np.pi * i / n_lat
        for k in range(n_lon):
            ph = 2 * np.pi * k / n_lon
            verts.append([r * np.sin(th) * np.cos(ph), r * np.cos(th),
                          r * np.sin(th) * np.sin(ph)])
    verts.append([0.0, -r, 0.0])
    faces = []
    ring = lambda i, k: 1 + (i - 1) * n_lon + k % n_lon  # noqa: E731
    for k in range(n_lon):
        faces.append([0, ring(1, k), ring(1, k + 1)])
        faces.append([len(verts) - 1, ring(n_lat - 1, k + 1),
                      ring(n_lat - 1, k)])
    for i in range(1, n_lat - 1):
        for k in range(n_lon):
            a, b = ring(i, k), ring(i, k + 1)
            c, d = ring(i + 1, k), ring(i + 1, k + 1)
            faces += [[a, c, b], [b, c, d]]
    return np.asarray(verts, np.float32), np.asarray(faces, np.int64)


def _on_edge(verts, faces, K4, res, pix, tol=1e-6):
    """Whether pixel (row, col) lies within ``tol`` of some face's edge
    (float64 edge functions)."""
    x = K4[0] * verts[:, 0].astype(np.float64) + K4[2]
    y = K4[1] * verts[:, 1].astype(np.float64) + K4[3]
    half = res / 2.0
    py = -((pix[0] + 0.5 - half) / half)
    px = -((pix[1] + 0.5 - half) / half)
    for f in faces:
        for a, b in ((f[1], f[2]), (f[2], f[0]), (f[0], f[1])):
            if abs((x[b] - x[a]) * (py - y[a])
                   - (y[b] - y[a]) * (px - x[a])) < tol:
                return True
    return False


@pytest.mark.parametrize("chunk", [7, 1024])
def test_rasterize_ortho_matches_jax(chunk):
    verts, faces = _sphere()
    rng = np.random.RandomState(12)
    verts = verts + rng.randn(*verts.shape).astype(np.float32) * 0.02
    verts = verts @ np.asarray(JFV.euler_rotation(
        jnp.asarray([[0.3, 0.4, 0.1]])))[0]
    attrs = (rng.rand(len(verts), 3) * 255).astype(np.float32)
    K4 = (-1.0, -1.0, 0.0, 0.0)
    img_j, depth_j, mask_j = JRAS.rasterize_ortho(
        jnp.asarray(verts), jnp.asarray(faces.astype(np.int32)),
        jnp.asarray(attrs), jnp.asarray(K4), 64, chunk=16)
    img_t, depth_t, mask_t = TRAS.rasterize_ortho(
        _t(verts), torch.from_numpy(faces), _t(attrs), K4, 64, chunk=chunk)
    mask_j, mask_t = np.asarray(mask_j), mask_t.numpy()
    assert 500 < mask_t.sum() < 64 * 64
    differ = np.argwhere(mask_j != mask_t)
    assert len(differ) <= 2
    assert all(_on_edge(verts, faces, K4, 64, p) for p in differ)
    both = mask_j & mask_t
    np.testing.assert_allclose(depth_t.numpy()[both], np.asarray(depth_j)[both],
                               atol=1e-5)
    assert (depth_t.numpy()[~mask_t] == 0).all()
    np.testing.assert_allclose(img_t.numpy()[both], np.asarray(img_j)[both],
                               atol=1e-3)


def test_depth2normal_and_condition_render_match_jax():
    rng = np.random.RandomState(13)
    depth = (rng.rand(20, 24) * 0.2 + 1.0).astype(np.float32)
    _close(TRAS.depth2normal_ortho(_t(depth), 0.05, -0.03),
           JRAS.depth2normal_ortho(jnp.asarray(depth), 0.05, -0.03),
           atol=1e-5)
    verts, faces = _sphere()
    colors = (rng.rand(len(verts), 3) * 300 - 20).astype(np.float32)
    rot = TP.ortho_view_rotations("cpu")["left"]
    np.testing.assert_array_equal(
        rot.numpy(), np.asarray(JP.ortho_view_rotations()["left"]))
    img_t, n_t = TRAS.render_ortho_condition(_t(verts), torch.from_numpy(faces),
                                             _t(colors), rot, TP.ORTHO_K, 64)
    img_j, n_j = JRAS.render_ortho_condition(
        jnp.asarray(verts), jnp.asarray(faces.astype(np.int32)),
        jnp.asarray(colors), jnp.asarray(rot.numpy()), TP.ORTHO_K, 64)
    np.testing.assert_allclose(img_t.numpy(), np.asarray(img_j), atol=1e-3)
    # normals: 1e-5 of the unit normal, in 0-255 units
    np.testing.assert_allclose(n_t.numpy(), np.asarray(n_j), atol=127.5e-5)
    assert (n_t.numpy() == 0).any() and (n_t.numpy() > 0).any()


# ---------------------------------------------------------------------------
# split writers, video crop, backends
# ---------------------------------------------------------------------------

def _tracking(base, save, fids, res=32):
    import cv2

    rng = np.random.RandomState(14)
    for i, fid in enumerate(fids):
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = np.asarray(JFV.euler_rotation(
            jnp.asarray([[0.05 * i, -0.02 * i, 0.01]])))[0]
        T[3, :3] = [0.01 * i, 0.02, -0.01 * i]
        JP.save_frame_assets(save, fid, rng.randn(611).astype(np.float32),
                             head_T=T, extr=T * 1.1, transformation=T * 1.1)
        os.makedirs(os.path.join(save, fid, "drive"), exist_ok=True)
        for d in (f"mv_rgb{res}", f"mv_mask{res}"):
            os.makedirs(os.path.join(base, d, "0"), exist_ok=True)
            cv2.imwrite(os.path.join(base, d, "0", f"{fid}.png"),
                        np.zeros((res, res, 3), np.uint8))


def test_split_writers_match_jax(tmp_path):
    base = str(tmp_path / "b")
    save = os.path.join(base, "tracking")
    fids = [str(i) for i in range(8)]
    _tracking(base, save, fids)
    coeffs = np.random.RandomState(15).randn(611).astype(np.float32)
    T = np.eye(4, dtype=np.float32)
    TP.save_frame_assets(str(tmp_path / "t"), "3", coeffs, T, T * 2, T * 3)
    JP.save_frame_assets(str(tmp_path / "j"), "3", coeffs, T, T * 2, T * 3)
    for name in ("coeffs.npy", "metaFace_extr.npz", "finish"):
        assert (open(tmp_path / "t" / "3" / name, "rb").read()
                == open(tmp_path / "j" / "3" / name, "rb").read())
    np.testing.assert_array_equal(TP.rotate_by_theta_along_y(0.3),
                                  JP.rotate_by_theta_along_y(0.3))
    calib = {"img_res": 32, "intrinsics": {"0": {
        "cam_K": [[1315.0, 0, 16], [0, 1315.0, 16], [0, 0, 1]],
        "cam_T": np.eye(4).tolist()}}}

    def split(fn, *a, **kw):
        path = fn(*a, **kw)
        text = open(path).read()
        os.remove(path)
        return text

    for shuffle in (False, True):
        assert (split(TP.make_transform, base, save, calib, ["0"], "2",
                      shuffle=shuffle, seed=3)
                == split(JP.make_transform, base, save, calib, ["0"], "2",
                         shuffle=shuffle, seed=3))
    K = np.asarray(calib["intrinsics"]["0"]["cam_K"], np.float32)
    for views in (1, 4):
        want = split(JP.make_animation_transform, base, save, calib, "2", K,
                     os.path.join(save, "0"), "drive", view_num=views)
        if views > 1:
            sel = open(os.path.join(base, "drive_drive_freeview_selected.json"
                                    )).read()
        got = split(TP.make_animation_transform, base, save, calib, "2", K,
                    os.path.join(save, "0"), "drive", view_num=views)
        assert got == want and json.loads(got)["frames"]
        if views > 1:
            assert open(os.path.join(
                base, "drive_drive_freeview_selected.json")).read() == sel


def test_video_crop_and_backends_match_jax(tmp_path):
    import cv2

    rng = np.random.RandomState(16)
    lms = (rng.rand(478, 2) * 100 + 50).astype(np.float32)
    assert (TV.crop_params_from_mediapipe(lms, 64)
            == JV.crop_params_from_mediapipe(lms, 64))
    assert (TV.crop_params_from_landmarks(lms[:68], 64)
            == JV.crop_params_from_landmarks(lms[:68], 64))

    video = str(tmp_path / "v.avi")
    vw = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"MJPG"), 10, (96, 80))
    assert vw.isOpened()
    for i in range(4):
        vw.write((rng.rand(80, 96, 3) * 255).astype(np.uint8))
    vw.release()
    lms_dir = tmp_path / "lms"
    lms_dir.mkdir()
    face = np.full((478, 2), 48.0, np.float32)
    face[105], face[334], face[152], face[6] = [40, 30], [56, 30], [48, 60], [48, 40]
    np.save(lms_dir / "0.npy", face)
    outs = {}
    for tag, V, LM in (("t", TV, TLM), ("j", JV, JLM)):
        be = LM.PrecomputedBackend(str(lms_dir))

        def detect(frame, be=be):
            be.set_frame("0")
            return be.detect(frame)

        base = str(tmp_path / tag)
        assert V.extract_video_frames(video, base, detect, 32) == 3
        mask_dir = os.path.join(base, "masks")
        os.makedirs(mask_dir)
        for i in range(4):
            cv2.imwrite(os.path.join(mask_dir, f"{i}.png"),
                        (rng.rand(32, 32) * 255).astype(np.uint8))
        V.run_matting(base, TMAT.PrecomputedBackend(mask_dir) if tag == "t"
                      else JMAT.PrecomputedBackend(mask_dir), 32)
        outs[tag] = base
    for d in ("mv_rgb32/0", "mv_mask32/0"):
        names = sorted(os.listdir(os.path.join(outs["t"], d)))
        assert names == sorted(os.listdir(os.path.join(outs["j"], d)))
        assert len(names) == 4
    assert (open(os.path.join(outs["t"], "crop_param.json")).read()
            == open(os.path.join(outs["j"], "crop_param.json")).read())
    for n in range(4):
        for d in ("mv_rgb32/0",):
            np.testing.assert_array_equal(
                cv2.imread(os.path.join(outs["t"], d, f"{n}.png")),
                cv2.imread(os.path.join(outs["j"], d, f"{n}.png")))

    frame = (rng.rand(8, 8, 3) * 255).astype(np.uint8)
    bg = (rng.rand(8, 8, 3) * 255).astype(np.uint8)
    np.testing.assert_array_equal(TMAT.ThresholdBackend(bg).alpha(frame),
                                  JMAT.ThresholdBackend(bg).alpha(frame))
    be = TLM.PrecomputedBackend(str(lms_dir))
    be.set_frame("7")
    assert be.detect(frame) is None
    with pytest.raises(RuntimeError, match="landmark weights not found"):
        TLM.get_backend("openseeface")
