"""havatar_tpu_torch.ops vs havatar_tpu.ops on the same numpy inputs.

Everything runs in float32 on the CPU. Tolerance: atol 1e-5 unless a case
says otherwise. Both sides compute the same formulas; what differs is
summation order and libm, a few f32 ulps on O(1) values.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from havatar_tpu import ops as J
from havatar_tpu_torch.ops import boxwarp, embedding, fused_act, grid_sample
from havatar_tpu_torch.ops import rays as R
from havatar_tpu_torch.ops import upfirdn2d as U
from havatar_tpu_torch.ops import volume_render as V

ATOL = 1e-5


def _close(got, want, atol=ATOL, rtol=1e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=atol, rtol=rtol)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def test_get_rays_np_is_the_same_function():
    c2w = np.array([[1.0, 0.0, 0.0, 0.0], [0.0, -1.0, 0.0, -0.1],
                    [0.0, 0.0, -1.0, 3.0]], np.float32)
    intr = (1.2 * 16, 1.2 * 16, 0.5, 0.5)
    for got, want in zip(R.get_rays_np(16, 12, intr, c2w),
                         J.get_rays_np(16, 12, intr, c2w)):
        np.testing.assert_array_equal(got, want)


def test_ray_aabb_near_far_including_slab_face_origins():
    rng = np.random.RandomState(0)
    n = 64
    ro = rng.randn(n, 3).astype(np.float32) * 2
    rd = rng.randn(n, 3).astype(np.float32)
    # parallel rays: inside, outside, and ON a slab face (the NaN case)
    rd[:6, 0] = 0.0
    ro[0, 0], ro[1, 0], ro[2, 0] = 0.0, 5.0, -1.0      # -1 is the box face
    ro[3, 0] = 1.0
    box_min = np.array([-1.0, -1.5, -0.5], np.float32)
    box_max = np.array([1.0, 1.2, 0.7], np.float32)
    near = np.full((n, 1), 0.1, np.float32)
    far = np.full((n, 1), 6.0, np.float32)
    got = R.ray_aabb_near_far(_t(ro), _t(rd), _t(box_min), _t(box_max),
                              _t(near), _t(far))
    want = J.ray_aabb_near_far(*(jnp.asarray(a) for a in
                                 (ro, rd, box_min, box_max, near, far)))
    for g, w in zip(got, want):
        assert np.isfinite(g.numpy()).all()
        _close(g, w)


def _head_T(rng, B):
    ang = rng.randn(B) * 0.2
    T = np.zeros((B, 4, 3), np.float32)
    for b in range(B):
        c, s = np.cos(ang[b]), np.sin(ang[b])
        T[b, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
        T[b, 3] = rng.randn(3) * 0.05
    return T


def test_head_world_aabb_and_tighten():
    rng = np.random.RandomState(1)
    B, n = 2, 32
    T = _head_T(rng, B)
    bounds = ((-1.5, 1.5), (-1.6, 1.4), (-1.6, 1.2))
    for g, w in zip(R.head_world_aabb(bounds, _t(T)),
                    J.head_world_aabb(bounds, jnp.asarray(T))):
        _close(g, w)
    rays = np.concatenate([
        np.tile([0.0, -0.1, 3.0], (B, n, 1)),
        rng.randn(B, n, 3) * 0.3 + [0, 0, -1.0],
        np.full((B, n, 1), 1.4), np.full((B, n, 1), 4.0)], -1
    ).astype(np.float32)
    _close(R.tighten_ray_near_far(_t(rays), bounds, _t(T)),
           J.tighten_ray_near_far(jnp.asarray(rays), bounds, jnp.asarray(T)))


def test_box_warp():
    bounds = ((-1.5, 1.5), (0.42, 1.4), (-1.6, 1.2))
    assert (boxwarp.get_box_warp_param(*bounds)
            == J.get_box_warp_param(*bounds))
    pts = np.random.RandomState(2).randn(5, 7, 3).astype(np.float32)
    _close(boxwarp.BoxWarp.from_bounds(bounds)(_t(pts)),
           J.BoxWarp.from_bounds(bounds)(jnp.asarray(pts)))


def test_positional_encoding():
    x = np.random.RandomState(3).randn(4, 9, 3).astype(np.float32)
    got = embedding.positional_encoding(_t(x), 8)
    assert got.shape[-1] == embedding.posenc_dim(8) == 48
    # sin of arguments up to 2^7 * |x| ~ 500: f32 argument rounding
    # differs by an ulp of the argument between the two libms
    _close(got, J.positional_encoding(jnp.asarray(x), 8,
                                      include_input=False), atol=1e-4)


def test_grid_sample_2d_quad_zeros():
    rng = np.random.RandomState(4)
    B, H, W, C, N = 2, 9, 7, 5, 300
    feat = rng.randn(B, H, W, C).astype(np.float32)
    # spans past [-1, 1] so out-of-range corners (zeros padding) occur,
    # plus exact texel hits and the +1 edge
    coords = rng.uniform(-1.3, 1.3, (B, N, 2)).astype(np.float32)
    coords[:, :3] = [[-1.0, -1.0], [1.0, 1.0], [0.0, 0.25]]
    rows, w4 = grid_sample.grid_sample_2d_quad(_t(feat), _t(coords))
    want_rows, want_w4 = J.grid_sample_2d_quad(
        jnp.asarray(feat), jnp.asarray(coords), "zeros")
    np.testing.assert_array_equal(rows.numpy(), np.asarray(want_rows))
    _close(w4, want_w4)
    # and the reduced value equals the full sampler's
    val = torch.einsum("bnkc,bnk->bnc", rows.view(B, N, 4, C), w4)
    _close(val, J.grid_sample_2d(jnp.asarray(feat), jnp.asarray(coords),
                                 "zeros"))


def test_grid_sample_3d_border():
    rng = np.random.RandomState(5)
    B, D, H, W, C, N = 2, 6, 5, 8, 2, 300
    vol = rng.randn(B, D, H, W, C).astype(np.float32)
    coords = rng.uniform(-1.4, 1.4, (B, N, 3)).astype(np.float32)
    coords[:, :2] = [[-1.0, -1.0, -1.0], [1.0, 1.0, 1.0]]
    _close(grid_sample.grid_sample_3d(_t(vol), _t(coords)),
           J.grid_sample_3d(jnp.asarray(vol), jnp.asarray(coords),
                            padding_mode="border"))


def test_cumprod_and_volume_render():
    rng = np.random.RandomState(6)
    Rn, S, Cf = 40, 12, 6
    rad = rng.randn(Rn, S, Cf + 1).astype(np.float32) * 2
    z = np.sort(rng.rand(Rn, S).astype(np.float32) * 3 + 1, -1)
    rd = rng.randn(Rn, 3).astype(np.float32)
    bg = rng.rand(Rn, 3).astype(np.float32)
    x = rng.rand(Rn, S).astype(np.float32)
    _close(V.cumprod_exclusive(_t(x)), J.cumprod_exclusive(jnp.asarray(x)))
    got = V.volume_render_radiance_field(_t(rad), _t(z), _t(rd), _t(bg))
    want = J.volume_render_radiance_field(
        jnp.asarray(rad), jnp.asarray(z), jnp.asarray(rd),
        background_prior=jnp.asarray(bg))
    for g, w in zip(got, want):
        # disp = 1/(depth/acc): ~1/3-scale values, relative tolerance
        _close(g, w, rtol=1e-4)


def test_sample_pdf_det():
    rng = np.random.RandomState(7)
    Rn, S = 50, 16
    z = np.sort(rng.rand(Rn, S).astype(np.float32) * 2 + 1, -1)
    bins = 0.5 * (z[:, 1:] + z[:, :-1])
    w = rng.rand(Rn, S - 2).astype(np.float32)
    w[:5] = 0.0                 # flat pdf: every cdf step equal
    w[5:10, 3:] = 0.0           # tiny steps: the denom < 1e-5 rule
    _close(V.sample_pdf(_t(bins), _t(w), 16),
           J.sample_pdf(jnp.asarray(bins), jnp.asarray(w), 16, det=True))


@pytest.mark.parametrize("up,down,pad", [
    (1, 1, (1, 2)), (2, 1, (2, 1)), (1, 2, (1, 1)), (2, 1, (1, 0, 1, 0)),
    (1, 2, (2, 2)), ((2, 1), (1, 2), (0, 1, 2, 0))])
def test_upfirdn2d(up, down, pad):
    rng = np.random.RandomState(8)
    x = rng.randn(2, 9, 8, 3).astype(np.float32)            # NHWC
    k = rng.rand(4, 4).astype(np.float32)
    got = U.upfirdn2d(_t(x).permute(0, 3, 1, 2), _t(k), up=up, down=down,
                      pad=pad)
    want = J.upfirdn2d(jnp.asarray(x), jnp.asarray(k), up=up, down=down,
                       pad=pad)
    _close(got.permute(0, 2, 3, 1), want)


def _upfirdn2d_native(x, k, up, down, pad):
    """StyleGAN's upfirdn2d_native in numpy: [H, W] x, scalar up/down."""
    px0, px1, py0, py1 = pad
    H, W = x.shape
    o = np.zeros((H * up, W * up), np.float32)
    o[::up, ::up] = x
    o = np.pad(o, ((max(py0, 0), max(py1, 0)), (max(px0, 0), max(px1, 0))))
    o = o[max(-py0, 0):o.shape[0] - max(-py1, 0),
          max(-px0, 0):o.shape[1] - max(-px1, 0)]
    kf, (kh, kw) = k[::-1, ::-1], k.shape
    out = np.array([[np.sum(o[i:i + kh, j:j + kw] * kf)
                     for j in range(o.shape[1] - kw + 1)]
                    for i in range(o.shape[0] - kh + 1)], np.float32)
    return out[::down, ::down]


@pytest.mark.parametrize("up,down,pad", [
    (1, 2, (-1, 2, 0, -1)), (2, 1, (-2, 1, 1, -1))])
def test_upfirdn2d_negative_pad(up, down, pad):
    """Negative pads crop. Held against StyleGAN's native reference: the
    JAX version disagrees with it at (1, 2, (-1, 2, 0, -1)) on XLA:CPU. The
    model itself never pads negatively."""
    rng = np.random.RandomState(8)
    x = rng.randn(9, 8).astype(np.float32)
    k = rng.rand(4, 4).astype(np.float32)
    got = U.upfirdn2d(_t(x)[None, None], _t(k), up=up, down=down, pad=pad)
    _close(got[0, 0], _upfirdn2d_native(x, k, up, down, pad))


def test_resampling_haar_and_act():
    rng = np.random.RandomState(9)
    x = rng.randn(2, 8, 8, 4).astype(np.float32)
    xt = _t(x).permute(0, 3, 1, 2)
    xj = jnp.asarray(x)
    kt, kj = U.make_kernel((1, 3, 3, 1)), J.make_kernel((1, 3, 3, 1))
    _close(kt, kj)

    def nhwc(t):
        return t.permute(0, 2, 3, 1)

    _close(nhwc(U.upsample2d(xt, kt)), J.upsample2d(xj, kj))
    _close(nhwc(U.downsample2d(xt, kt)), J.downsample2d(xj, kj))
    _close(nhwc(U.blur(xt, kt, (2, 1), upsample_factor=2)),
           J.blur(xj, kj, (2, 1), upsample_factor=2))
    h = U.haar_transform(xt)
    _close(nhwc(h), J.haar_transform(xj))
    _close(nhwc(U.inverse_haar_transform(h)),
           J.inverse_haar_transform(J.haar_transform(xj)))
    _close(U.inverse_haar_transform(h), xt)    # perfect reconstruction
    b = rng.randn(4).astype(np.float32)
    _close(nhwc(fused_act.fused_leaky_relu(xt, _t(b))),
           J.fused_leaky_relu(xj, jnp.asarray(b)))
