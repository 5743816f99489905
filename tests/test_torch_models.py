"""havatar_tpu_torch.models vs havatar_tpu.models at tiny widths, weights
carried across by havatar_tpu_torch.checkpoints.convert.

Weights: the JAX modules' own initialization, with every zero-initialized
bias replaced by numpy normals so that bias paths are exercised. Inputs:
numpy RandomState. All float32 on the CPU. Tolerance 1e-4 absolute and
relative where convolutions are involved (f32 sums of up to 9 x 1024
products in different orders in XLA and oneDNN), 1e-5 otherwise.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from havatar_tpu.checkpoints import convert as JC
from havatar_tpu.models import blocks as JB
from havatar_tpu.models import generators as JG
from havatar_tpu.models import nerf_field as JF
from havatar_tpu.models import renderer as JR
from havatar_tpu.models import skinning as JS
from havatar_tpu_torch.checkpoints import convert as TC
from havatar_tpu_torch.infer.reenact import seeded_init_
from havatar_tpu_torch.models import blocks as TB
from havatar_tpu_torch.models import generators as TG
from havatar_tpu_torch.models import nerf_field as TF
from havatar_tpu_torch.models import renderer as TR
from havatar_tpu_torch.models import skinning as TS
from havatar_tpu_torch.ops import march as TM

CONV_TOL = dict(atol=1e-4, rtol=1e-4)


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _with_random_biases(tree, rng):
    """Zero-initialized leaves (biases, noise weights) -> N(0, 0.3^2)."""
    def f(a):
        a = np.asarray(a, np.float32)
        if not a.any():
            return (rng.randn(*a.shape) * 0.3).astype(np.float32)
        return a
    return jax.tree_util.tree_map(f, tree)


def _init(module, rng, *args, **kw):
    # jitted: one compile is quicker on the CPU than op-by-op dispatch
    init = jax.jit(functools.partial(module.init, **kw))
    variables = init(jax.random.PRNGKey(0), *args)
    variables = _np_tree(jax.tree_util.tree_map(lambda a: a, variables))
    variables = dict(variables)
    variables["params"] = _with_random_biases(variables["params"], rng)
    return variables


def _apply(module, variables, *args, **kw):
    """module.apply, jitted (quicker than op-by-op dispatch on the CPU)."""
    return jax.jit(functools.partial(module.apply, **kw))(variables, *args)


def _load(module, sd, prefix=""):
    if prefix:
        sd = {k[len(prefix) + 1:]: v for k, v in sd.items()
              if k.startswith(prefix + ".")}
    module.load_state_dict(sd, strict=True)
    return module.eval()


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def _close(got_nchw, want_nhwc, **tol):
    np.testing.assert_allclose(
        got_nchw.detach().permute(0, 2, 3, 1).numpy(),
        np.asarray(want_nhwc, np.float32), **(tol or CONV_TOL))


@pytest.mark.parametrize("downsample", [False, True])
def test_conv_layer_and_block(downsample):
    rng = np.random.RandomState(0)
    x = rng.randn(2, 8, 8, 6).astype(np.float32)
    j = JB.ConvLayer(5, 3, downsample=downsample)
    v = _init(j, rng, jnp.asarray(x))
    t = _load(TB.ConvLayer(6, 5, 3, downsample=downsample),
              TC._conv_layer(v["params"], "m", downsample), "m")
    with torch.no_grad():
        _close(t(_nchw(x)), j.apply(v, jnp.asarray(x)))
    jb = JB.ConvBlock(6, 7)
    vb = _init(jb, rng, jnp.asarray(x))
    sd = {**TC._conv_layer(vb["params"]["conv1"], "conv1", False),
          **TC._conv_layer(vb["params"]["conv2"], "conv2", True)}
    with torch.no_grad():
        _close(_load(TB.ConvBlock(6, 7), sd)(_nchw(x)),
               jb.apply(vb, jnp.asarray(x)))


@pytest.mark.parametrize("use_wt", [False, True])
def test_from_rgb(use_wt):
    rng = np.random.RandomState(1)
    img = rng.randn(2, 8, 8, 12).astype(np.float32)
    skip = rng.randn(2, 4, 4, 5).astype(np.float32)
    j = JB.FromRGB(5, downsample=True, use_wt=use_wt)
    v = _init(j, rng, jnp.asarray(img), jnp.asarray(skip))
    t = _load(TB.FromRGB(12, 5, downsample=True, use_wt=use_wt),
              TC._conv_layer(v["params"]["conv"], "conv", False))
    with torch.no_grad():
        got = t(_nchw(img), _nchw(skip))
    for g, w in zip(got, j.apply(v, jnp.asarray(img), jnp.asarray(skip))):
        _close(g, w)


@pytest.mark.parametrize("upsample", [False, True])
def test_styled_conv(upsample):
    rng = np.random.RandomState(2)
    x = rng.randn(2, 6, 6, 8).astype(np.float32)
    style = rng.randn(2, 10).astype(np.float32)
    j = JB.StyledConv(8, 9, 3, upsample=upsample)
    v = _init(j, rng, jnp.asarray(x), jnp.asarray(style))
    t = _load(TB.StyledConv(8, 9, 3, 10, upsample=upsample),
              TC._styled_conv(v["params"], "m"), "m")
    with torch.no_grad():
        _close(t(_nchw(x), torch.from_numpy(style)),
               j.apply(v, jnp.asarray(x), jnp.asarray(style)))


def test_to_rgb_with_wavelet_skip():
    rng = np.random.RandomState(3)
    x = rng.randn(2, 8, 8, 9).astype(np.float32)
    style = rng.randn(2, 10).astype(np.float32)
    skip = rng.randn(2, 4, 4, 12).astype(np.float32)
    j = JB.ToRGB(9, out_channel=12)
    v = _init(j, rng, jnp.asarray(x), jnp.asarray(style), jnp.asarray(skip))
    sd = TC._modconv(v["params"]["conv"], "conv")
    sd["bias"] = torch.from_numpy(
        v["params"]["bias"].transpose(0, 3, 1, 2).copy())
    t = _load(TB.ToRGB(9, 12, 10), sd)
    with torch.no_grad():
        _close(t(_nchw(x), torch.from_numpy(style), _nchw(skip)),
               j.apply(v, jnp.asarray(x), jnp.asarray(style),
                       jnp.asarray(skip)))


def test_equal_linear_style_mlp():
    rng = np.random.RandomState(4)
    z = rng.randn(3, 12).astype(np.float32)
    j = JG.StyleMLP(12, 8, 3)
    v = _init(j, rng, jnp.asarray(z))
    sd = {}
    for i in range(3):
        sd.update(TC._linear(v["params"][f"fc{i}"], str(i + 1)))
    t = _load(TG.StyleMLP(12, 8, 3), sd)
    with torch.no_grad():
        np.testing.assert_allclose(t(torch.from_numpy(z)).numpy(),
                                   np.asarray(j.apply(v, jnp.asarray(z))),
                                   atol=1e-5, rtol=1e-5)


def test_plane_generator():
    rng = np.random.RandomState(5)
    z = rng.randn(2, 12).astype(np.float32)
    cond = rng.rand(2, 64, 64, 7).astype(np.float32)
    kw = dict(out_ch=8, out_size=32, style_dim=12, mlp_dim=8, n_mlp=2,
              middle_size=8, inp_size=64, inp_ch=7)
    j = JG.PlaneGenerator(**kw)
    v = _init(j, rng, jnp.asarray(z), jnp.asarray(cond))
    t = _load(TG.PlaneGenerator(**kw), TC.from_jax_params(v))
    with torch.no_grad():
        _close(t(torch.from_numpy(z), _nchw(cond)),
               _apply(j, v, jnp.asarray(z), jnp.asarray(cond)))


def test_styleunet_sr():
    rng = np.random.RandomState(6)
    z = rng.randn(2, 16).astype(np.float32)
    cond = rng.randn(2, 32, 32, 8).astype(np.float32)
    kw = dict(inp_size=32, inp_ch=8, out_ch=3, out_size=128, style_dim=16,
              n_mlp=2, middle_size=8, channel_multiplier=1)
    j = JG.StyleUNetSR(**kw)
    v = _init(j, rng, jnp.asarray(z), jnp.asarray(cond))
    t = _load(TG.StyleUNetSR(**kw), TC.from_jax_params(v))
    with torch.no_grad():
        _close(t(torch.from_numpy(z), _nchw(cond)),
               _apply(j, v, [jnp.asarray(z)], jnp.asarray(cond)))
    # and the port's state_dict reads back through the JAX converter
    back = JC.convert_styleunet(t.state_dict(), out_size=128, inp_size=32,
                                middle_size=8, n_mlp=2)
    _assert_trees_equal(back, v["params"])


def _assert_trees_equal(got, want):
    g = jax.tree_util.tree_flatten_with_path(got)[0]
    w = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    assert len(g) == len(w)
    for path, leaf in g:
        np.testing.assert_array_equal(np.asarray(leaf), w[path],
                                      err_msg=jax.tree_util.keystr(path))


def _head_T(rng, B):
    rot = np.eye(3) + 0.15 * rng.randn(3, 3)
    T = np.concatenate([np.linalg.inv(rot), 0.05 * rng.randn(1, 3)], 0)
    return np.broadcast_to(T, (B, 4, 3)).astype(np.float32).copy()


def test_volume_decoder_fix_and_skinning():
    rng = np.random.RandomState(7)
    B, N = 2, 200
    pts = (rng.randn(B, N, 3) * 0.8).astype(np.float32)
    T = _head_T(rng, B)
    scales, trans = JR.get_box_warp_param((-1.5, 1.5), (0.42, 1.4),
                                          (-1.6, 1.2))
    j = JS.SkinningField(scales=scales, trans=trans, vol_res=8)
    v = _init(j, rng, jnp.asarray(pts), None, jnp.asarray(T))
    sd = TC.renderer_state_dict(
        {"params": {"skinning": v["params"]},
         "buffers": {"skinning": v["buffers"]}})
    t = _load(TS.SkinningField(scales, trans, vol_res=8), sd,
              "headpose_skin_net")
    with torch.no_grad():
        vol = t.volume()
        want_vol = _apply(j, v, method=JS.SkinningField.volume)
        np.testing.assert_allclose(
            vol.permute(0, 2, 3, 4, 1).numpy(), np.asarray(want_vol),
            atol=1e-5)
        fixed = TS.fix_canonical_volume(vol)
        want_fixed = JS.fix_canonical_volume(want_vol)
        np.testing.assert_allclose(
            fixed.permute(0, 2, 3, 4, 1).numpy(), np.asarray(want_fixed),
            atol=1e-5)
        got = t(torch.from_numpy(pts), torch.from_numpy(T), fixed)
    want, _ = _apply(j, v, jnp.asarray(pts), None, jnp.asarray(T),
                     want_fixed)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


FIELD = dict(num_encoding_fn_xyz=8, latent_code_dim=20, plane_feat_dim=16,
             plane_res=32, cond_res=32, plane_middle_size=8)


def test_field_planes_quad_inputs_and_mlp():
    rng = np.random.RandomState(8)
    B, N = 1, 300
    lat = rng.randn(B, 8).astype(np.float32)
    cond_c = rng.randn(B, 12).astype(np.float32)
    conds = [rng.rand(B, 32, 32, 7).astype(np.float32) for _ in range(3)]
    pts = rng.uniform(-1.6, 1.6, (B, N, 3)).astype(np.float32)
    j = JF.DoublePlaneNeRFField(**FIELD)
    jargs = [jnp.asarray(a) for a in (lat, cond_c, *conds)]
    v = _init(j, rng, jnp.asarray(pts), None,
              jnp.zeros((2, B, 32, 32, 16)))
    v["params"] = {**v["params"], **{
        g: _init(JG.PlaneGenerator(out_ch=16, out_size=32, style_dim=20,
                                   middle_size=8, inp_size=32, inp_ch=c),
                 rng, jnp.zeros((B, 20)), jnp.zeros((B, 32, 32, c)))["params"]
        for g, c in (("XY_gen", 7), ("YZ_gen", 13))}}
    sd = TC.renderer_state_dict({"params": {"field": v["params"]}})
    t = _load(TF.DoublePlaneNeRFField(**FIELD), sd, "model_coarse")

    want_planes = _apply(j, v, *jargs,
                         method=JF.DoublePlaneNeRFField.generate_planes)
    with torch.no_grad():
        planes = t.generate_planes(*(torch.from_numpy(a) for a in
                                     (lat, cond_c, *conds)))
        np.testing.assert_allclose(planes.numpy(), np.asarray(want_planes),
                                   **CONV_TOL)
        planes = torch.from_numpy(np.array(want_planes))  # same planes
        quads, aux = t.field_inputs_quad(torch.from_numpy(pts), planes)
    want_q, want_aux = _apply(j, v, jnp.asarray(pts), want_planes,
                              method=JF.DoublePlaneNeRFField
                              .field_inputs_quad)
    np.testing.assert_array_equal(quads.numpy(), np.asarray(want_q))
    np.testing.assert_allclose(aux.numpy(), np.asarray(want_aux), atol=1e-4)
    # the five dense layers, through the twin's MLP on the quad inputs
    # (block order + permuted layer0) vs the JAX field's XLA path
    with torch.no_grad():
        mp = t.march_params(torch.float32)
        x = TM._build_x(quads[0], aux[0], 16, 48)
        rgb, feat, sigma = TM._mlp(x, mp)
    want = np.asarray(_apply(j, v, jnp.asarray(pts), None, want_planes))[0]
    got = torch.cat([rgb, feat, sigma[:, None]], -1).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_renderer_state_dict_round_trip():
    """JAX renderer variables -> from_jax_params -> port state_dict (strict
    load) -> havatar_tpu's convert_renderer gives back the same arrays.

    The JAX variables are havatar_tpu's own converter output for a random
    renderer (numpy-seeded), so no JAX module is initialised here; the
    module tests above feed JAX-initialised trees through the same code.
    convert_renderer reads the volume decoder at its production depth
    (64^3), so the skinning volume has that size."""
    kw = dict(latent_code_dim=8, plane_feat_dim=16, plane_res=32,
              cond_res=32, plane_middle_size=8, skin_vol_res=64,
              render_size=4)
    src = seeded_init_(TR.AvatarRenderer(**kw), seed=9)
    with torch.no_grad():
        for name, p in src.named_parameters():
            if name.endswith("bias"):
                p.normal_(generator=torch.Generator().manual_seed(len(name)))
    v = JC.convert_renderer(src.state_dict())["variables"]
    t = _load(TR.AvatarRenderer(**kw), TC.from_jax_params(v))
    back = JC.convert_renderer(t.state_dict())
    assert back["enc_mode"] == "split"
    _assert_trees_equal(back["variables"]["params"], v["params"])
    _assert_trees_equal(back["variables"]["buffers"], v["buffers"])
