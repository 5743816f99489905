"""The ops and optional heads of havatar_tpu_torch against havatar_tpu, on
the CPU: ``eval_sh`` (degrees 0 to 4), the field's ``sh_deg > 0`` head, the
wavelet discriminator's pose-conditional head (``c_dim > 0``), 2D
``border`` padding (values and both gradients) and
``sample_image_features``, the ray helpers ``intrinsics_to_K``,
``get_rays``, ``perspective_project`` and ``project_multiview``, and
``BoxWarpLegacy``.

Inputs from numpy RandomState; float32. Tolerances are those of
tests/test_ops.py (grid sampling rtol 1e-4, atol 1e-5) and
tests/test_torch_models.py / test_torch_stage2.py (modules 1e-4 absolute
and relative; gradients per tensor 2e-4 of the largest entry); the rest
1e-6 absolute (the same float32 operations in the same order).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from havatar_tpu import ops as J
from havatar_tpu.checkpoints import convert as JC
from havatar_tpu.models import discriminator as JD
from havatar_tpu.models import nerf_field as JF
from havatar_tpu_torch.checkpoints import convert as TC
from havatar_tpu_torch.models import discriminator as TD
from havatar_tpu_torch.models import nerf_field as TF
from havatar_tpu_torch.ops import boxwarp as TBW
from havatar_tpu_torch.ops import grid_sample as TGS
from havatar_tpu_torch.ops import mlp as TMLP
from havatar_tpu_torch.ops import rays as TR
from havatar_tpu_torch.ops.sh import eval_sh

from test_torch_models import (CONV_TOL, FIELD, _assert_trees_equal, _init,
                               _load, _nchw)
from test_torch_stage2 import D_KW, assert_grads_close

GS_TOL = dict(rtol=1e-4, atol=1e-5)


def _unit(rng, *shape):
    d = rng.randn(*shape, 3).astype(np.float32)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


@pytest.mark.parametrize("deg", [0, 1, 2, 3, 4])
def test_eval_sh_matches_jax(deg):
    rng = np.random.RandomState(deg)
    sh = rng.randn(7, 3, (deg + 1) ** 2).astype(np.float32)
    dirs = _unit(rng, 7)
    want = J.eval_sh(deg, jnp.asarray(sh), jnp.asarray(dirs))
    got = eval_sh(deg, torch.from_numpy(sh), torch.from_numpy(dirs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-6)
    with pytest.raises(ValueError):
        eval_sh(deg, torch.zeros(7, 3, (deg + 1) ** 2 + 1),
                torch.from_numpy(dirs))


def test_field_sh_head_matches_jax():
    """A field with sh_deg = 2: fc_rgb 27 wide crosses through
    from_jax_params, rgb is the SH at the view directions (CONV_TOL
    against the JAX field); the fused-chain flag leaves that path alone
    (the chain computes the sh_deg = 0 head only)."""
    rng = np.random.RandomState(3)
    B, N = 1, 200
    pts = rng.uniform(-1.6, 1.6, (B, N, 3)).astype(np.float32)
    dirs = _unit(rng, B, N)
    planes = rng.randn(2, B, 32, 32, 16).astype(np.float32)
    j = JF.DoublePlaneNeRFField(**FIELD, sh_deg=2)
    v = _init(j, rng, jnp.asarray(pts), jnp.asarray(dirs),
              jnp.asarray(planes))
    assert v["params"]["fc_rgb"]["kernel"].shape == (64, 27)
    want = jax.jit(j.apply)(v, jnp.asarray(pts), jnp.asarray(dirs),
                            jnp.asarray(planes))
    sd = TC.renderer_state_dict({"params": {"field": v["params"]}})
    sd = {k: w for k, w in sd.items() if not k.split(".")[1].endswith("gen")}
    for fused in (False, True):
        t = TF.DoublePlaneNeRFField(**FIELD, sh_deg=2, use_fused_mlp=fused,
                                    use_fused_quad=fused)
        missing = t.load_state_dict(
            {k[len("model_coarse."):]: w for k, w in sd.items()},
            strict=False).missing_keys
        assert all("_gen." in k for k in missing)
        launches = TMLP.fused_mlp_chain.launches
        with torch.no_grad():
            got = t(torch.from_numpy(pts), torch.from_numpy(dirs),
                    torch.from_numpy(planes))
        assert TMLP.fused_mlp_chain.launches == launches
        assert got.shape == (B, N, 3 + 64 + 1)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **CONV_TOL)


def test_discriminator_pose_head_matches_jax():
    """c_dim = 25 on both sides (JAX's converter would detect c_dim = 1
    from the state dict, whatever the pose width: not its forward's
    divisor here). Scores CONV_TOL; the gradient of the scores' sum to
    every parameter per tensor 2e-4 of its largest entry; the mapping
    layers read back through convert_discriminator."""
    rng = np.random.RandomState(5)
    img = rng.rand(2, 64, 64, 3).astype(np.float32)
    pose = rng.randn(2, 25).astype(np.float32)
    j = JD.WaveletDiscriminator(**D_KW, c_dim=25)
    v = _init(j, rng, jnp.asarray(img), jnp.asarray(pose))
    t = _load(TD.WaveletDiscriminator(**D_KW, c_dim=25),
              TC.from_jax_params(v))
    assert [m.weight.shape[1] for m in t.mapping] == [25, 64, 64, 64]

    def score_sum(params):
        return jnp.sum(j.apply({"params": params}, jnp.asarray(img),
                               jnp.asarray(pose)))

    want = jax.jit(j.apply)(v, jnp.asarray(img), jnp.asarray(pose))
    jgrads = jax.jit(jax.grad(score_sum))(v["params"])
    got = t(_nchw(img), torch.from_numpy(pose))
    assert got.shape == (2, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **CONV_TOL)
    got.sum().backward()
    assert_grads_close({n: p.grad for n, p in t.named_parameters()},
                       TC.from_jax_params(jgrads))
    back = JC.convert_discriminator(t.state_dict(), size=64, c_dim=25)
    _assert_trees_equal(back, v["params"])
    with pytest.raises(ValueError):
        t(_nchw(img))


@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
def test_grid_sample_2d_padding_and_grads_match_jax(padding_mode):
    """Values against JAX and F.grid_sample, gradients to the features and
    the coordinates against JAX's custom VJP (points out of bounds
    included)."""
    rng = np.random.RandomState(11)
    feat = rng.randn(2, 9, 7, 5).astype(np.float32)
    coords = (rng.rand(2, 33, 2).astype(np.float32) * 2.6 - 1.3)
    cot = rng.randn(2, 33, 5).astype(np.float32)

    def jf(f, c):
        return jnp.sum(J.grid_sample_2d(f, c, padding_mode) * cot)

    want = J.grid_sample_2d(jnp.asarray(feat), jnp.asarray(coords),
                            padding_mode)
    dfeat, dcoords = jax.grad(jf, argnums=(0, 1))(jnp.asarray(feat),
                                                  jnp.asarray(coords))
    f_t = torch.from_numpy(feat).requires_grad_(True)
    c_t = torch.from_numpy(coords).requires_grad_(True)
    got = TGS.grid_sample_2d(f_t, c_t, padding_mode)
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **GS_TOL)
    ref = F.grid_sample(torch.from_numpy(np.moveaxis(feat, -1, 1)),
                        torch.from_numpy(coords).unsqueeze(-2),
                        padding_mode=padding_mode, align_corners=True)
    np.testing.assert_allclose(got.detach().numpy(),
                               ref[..., 0].permute(0, 2, 1).numpy(), **GS_TOL)
    np.testing.assert_allclose(f_t.grad.numpy(), np.asarray(dfeat), **GS_TOL)
    np.testing.assert_allclose(c_t.grad.numpy(), np.asarray(dcoords),
                               **GS_TOL)
    with pytest.raises(ValueError):
        TGS.grid_sample_2d(f_t, c_t, "reflection")


def test_sample_image_features_matches_jax():
    """[B, V, N, 2] x features [B, V, C, H, W] (JAX: [B, V, H, W, C]) ->
    [B, V, N, C], border padding by default."""
    rng = np.random.RandomState(12)
    feats = rng.randn(2, 3, 6, 8, 4).astype(np.float32)    # B, V, H, W, C
    xy = (rng.rand(2, 3, 17, 2).astype(np.float32) * 2.4 - 1.2)
    xy_t = torch.from_numpy(xy)
    feats_t = torch.from_numpy(np.ascontiguousarray(
        feats.transpose(0, 1, 4, 2, 3)))
    for mode in ("border", "zeros", None):
        kw = {} if mode is None else {"padding_mode": mode}
        want = J.sample_image_features(jnp.asarray(xy), jnp.asarray(feats),
                                       **kw)
        got = TGS.sample_image_features(xy_t, feats_t, **kw)
        assert got.shape == (2, 3, 17, 4)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **GS_TOL)


def test_intrinsics_and_get_rays_match_jax():
    intr = np.array([500.0, 510.0, 0.5, 0.52], np.float32)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = np.linalg.qr(np.random.RandomState(2).randn(3, 3))[0]
    c2w[:3, 3] = [0.1, -0.2, 2.5]
    np.testing.assert_array_equal(TR.intrinsics_to_K(intr, 12, 10),
                                  J.intrinsics_to_K(intr, 12, 10))
    ro_j, rd_j = J.get_rays(10, 12, jnp.asarray(intr), jnp.asarray(c2w))
    ro_t, rd_t = TR.get_rays(10, 12, intr, torch.from_numpy(c2w))
    assert rd_t.shape == (10, 12, 3) and ro_t.shape == (10, 12, 3)
    np.testing.assert_allclose(rd_t.numpy(), np.asarray(rd_j), atol=1e-6)
    np.testing.assert_array_equal(ro_t.numpy(), np.asarray(ro_j))
    ro_n, rd_n = TR.get_rays_np(10, 12, intr, c2w)
    np.testing.assert_allclose(rd_t.numpy(), rd_n, atol=1e-6)


def test_perspective_and_multiview_projection_match_jax():
    rng = np.random.RandomState(13)
    B, V, N = 2, 3, 11
    pts = rng.randn(B, N, 3).astype(np.float32)
    extrs = np.tile(np.eye(4, dtype=np.float32), (B, V, 1, 1))
    extrs[..., :3, :3] = np.linalg.qr(rng.randn(B, V, 3, 3))[0]
    extrs[..., :3, 3] = rng.randn(B, V, 3) * 0.1 + [0, 0, 6.0]
    K = np.asarray([[300.0, 0, 31.5], [0, 310.0, 32.0], [0, 0, 1]],
                   np.float32)
    intrs = np.tile(K, (B, V, 1, 1))
    for normalize in (False, True):
        want = J.perspective_project(jnp.asarray(pts[0]),
                                     jnp.asarray(extrs[0, 1]),
                                     jnp.asarray(K), normalize, 64, 60)
        got = TR.perspective_project(torch.from_numpy(pts[0]),
                                     torch.from_numpy(extrs[0, 1]),
                                     torch.from_numpy(K), normalize, 64, 60)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=1e-6)
    want = J.project_multiview(jnp.asarray(pts), jnp.asarray(extrs),
                               jnp.asarray(intrs), 64, 60)
    got = TR.project_multiview(torch.from_numpy(pts), torch.from_numpy(extrs),
                               torch.from_numpy(intrs), 64, 60)
    assert got.shape == (B, V, N, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-6)


def test_box_warp_legacy_matches_jax():
    scales, trans = (1 / 2.5, 1 / 2.5, 1 / 2.0), (0.0, 0.0, -0.2)
    pts = np.random.RandomState(14).randn(5, 3).astype(np.float32)
    j = J.BoxWarpLegacy(scales, trans)
    t = TBW.BoxWarpLegacy(scales, trans)
    got = t(torch.from_numpy(pts))
    np.testing.assert_allclose(got.numpy(), np.asarray(j(jnp.asarray(pts))),
                               atol=1e-6)
    np.testing.assert_allclose(t.inv(got).numpy(), pts, atol=1e-6)
    np.testing.assert_allclose(
        t.inv(got).numpy(), np.asarray(j.inv(jnp.asarray(got.numpy()))),
        atol=1e-6)
