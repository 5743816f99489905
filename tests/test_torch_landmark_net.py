"""havatar_tpu_torch.preprocess.landmark_net against havatar_tpu's on the
CPU.

Seeded port modules (numpy draws, BatchNorms not the identity) give their
``state_dict()`` to JAX's own ``convert_torch_*`` converters, and the same
numpy inputs go through both sides: the blocks (inverted residual with SE,
the stride-2 depthwise block and stem, the three DSConv2d heads, UNetUp
with the gaze net's 1x1 source) and the whole landmark net of every model
type at 224^2 (atol 2e-5, rtol 1e-4, JAX's own bound for these convs), the
detection and gaze nets, and the numpy decodes (exactly). The other way,
``checkpoints.convert.*_from_jax`` builds the port's modules from JAX's
BN-folded params (``init_landmark_params`` for the landmark net) and must
give JAX's outputs. Weight files load from ``.pth`` and ``.npz``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from havatar_tpu.preprocess import landmark_net as JL
from havatar_tpu_torch.checkpoints import convert as C
from havatar_tpu_torch.preprocess import landmark_net as L
from havatar_tpu_torch.preprocess.nets import load_reference, seed_

TOL = dict(atol=2e-5, rtol=1e-4)
CPU = torch.device("cpu")


def sd_np(module, prefix=""):
    return {prefix + k: v.numpy() for k, v in module.state_dict().items()}


def port(module, *xs):
    with torch.no_grad():
        out = module(*(L.nchw(x, CPU) for x in xs))
    return tuple(map(L.nhwc, out)) if isinstance(out, tuple) else L.nhwc(out)


def rand(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


@pytest.mark.parametrize("spec", [("ir", 5, 1, 3.0, 24, True, "relu"),
                                  ("ir", 3, 2, 4.5, 40, False, "hswish"),
                                  ("ds", 3, 2, 1.0, 16, True, "relu"),
                                  ("cn", 1, 1, 1.0, 48, False, "hswish")])
def test_blocks_match_jax(spec):
    btype, k, stride, e, cout, has_se, act = spec
    cin = 24 if btype == "ir" else 16
    blk = {"ir": lambda: L.InvertedResidual(cin, cout, k, stride, e, has_se, act),
           "ds": lambda: L.DepthwiseSeparable(cin, cout, k, stride, has_se, act),
           "cn": lambda: L.ConvBnAct(cin, cout, k, stride, act)}[btype]()
    seed_(blk, 1)
    p = JL._convert_block(sd_np(blk, "b."), "b", spec)
    x = rand(np.random.RandomState(2), 2, 28, 28, cin)
    want = np.asarray(jax.jit(lambda x: JL._block(x, p, spec))(jnp.asarray(x)))
    np.testing.assert_allclose(port(blk, x), want, **TOL)


def test_stem_stride2_padding_matches_jax():
    """The stride-2 stem pads k // 2 on both sides of an even input."""
    net = L.seeded_net("landmark", 3, 0)
    p = JL.convert_torch_landmark_model(sd_np(net), 0)
    x = rand(np.random.RandomState(3), 1, 56, 56, 3)
    with torch.no_grad():
        got = L.nhwc(net.bn1(net.conv_stem(L.nchw(x, CPU))))
    want = JL.conv2d(jnp.asarray(x), p["stem"]["w"], p["stem"]["b"], stride=2)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.mark.parametrize("old", [0, 1, 2])
def test_ds_heads_and_unet_up_match_jax(old):
    rng = np.random.RandomState(4 + old)
    head = seed_(L.DSConv2d(24, 12, kpl=4, groups=3 if old != 1 else 2,
                            old=old), old)
    params = {0: JL._ds_head_params, 1: JL._ds_head_old1_params,
              2: JL._ds_head_old2_params}[old](sd_np(head, "h."), "h.conv")
    fn = {0: JL.ds_head, 1: JL.ds_head_old1, 2: JL.ds_head_old2}[old]
    groups = 3 if old != 1 else 2
    x = rand(rng, 1, 14, 14, 24)
    np.testing.assert_allclose(
        port(head, x), np.asarray(fn(jnp.asarray(x), params, groups)), **TOL)

    up = seed_(L.UNetUp(16 + 8, 10, old), old + 10)
    params = {0: JL._ds_head_params, 1: JL._ds_head_old1_params,
              2: JL._ds_head_old2_params}[old](sd_np(up, "u."), "u.conv.conv")
    up_fn = {0: JL.unet_up, 1: JL.unet_up_old1, 2: JL.unet_up_old2}[old]
    for src in (7, 1):          # 1: the gaze net's 1x1 bottleneck
        x, skip = rand(rng, 2, src, src, 16), rand(rng, 2, 14, 14, 8)
        with torch.no_grad():
            got = L.nhwc(up(L.nchw(x, CPU), L.nchw(skip, CPU)))
        want = up_fn(jnp.asarray(x), jnp.asarray(skip), params, (14, 14))
        np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.mark.parametrize("model_type", [0, 1, 2, 3])
def test_landmark_net_matches_jax(model_type):
    net = L.seeded_net("landmark", 10 + model_type, model_type)
    p = JL.convert_torch_landmark_model(sd_np(net), model_type)
    x = rand(np.random.RandomState(model_type), 2, 224, 224, 3)
    want = np.asarray(jax.jit(lambda p, x: JL.apply_landmark_net(
        p, x, model_type))(p, jnp.asarray(x)))
    got = port(net, x)
    assert got.shape == (2, 28, 28, 198) and want.std() > 1e-2
    np.testing.assert_allclose(got, want, **TOL)
    for g, w in zip(got, want):
        # the offsets' logit multiplies a map's error by 1 / (p (1 - p))
        # (x 223 / 16 x the crop scale): 1e-2 px
        cg, lg = L.decode_landmarks(g, (5.0, 7.0, 1.5, 2.0))
        cw, lw = JL.decode_landmarks(w, (5.0, 7.0, 1.5, 2.0))
        assert cg == pytest.approx(cw, abs=1e-5)
        np.testing.assert_allclose(lg, lw, atol=1e-2)


def test_detection_and_gaze_nets_match_jax():
    rng = np.random.RandomState(5)
    net = L.seeded_net("detection", 6, confident=True)
    p = JL.convert_torch_detection_model(sd_np(net))
    x = rand(rng, 2, 224, 224, 3)
    got = port(net, x)
    want = jax.jit(JL.apply_detection_net)(p, jnp.asarray(x))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), **TOL)
    for i in range(2):
        boxes = L.decode_detections(got[0][i], got[1][i], (480, 640), 4)
        assert boxes.shape[0] >= 1       # the confident head finds a face
        np.testing.assert_allclose(boxes, JL.decode_detections(
            np.asarray(want[0][i]), np.asarray(want[1][i]), (480, 640), 4),
            atol=1e-3)

    net = L.seeded_net("gaze", 7)
    p = JL.convert_torch_gaze_model(sd_np(net))
    x = rand(rng, 2, 32, 32, 3)
    np.testing.assert_allclose(
        port(net, x), np.asarray(jax.jit(JL.apply_gaze_net)(p, jnp.asarray(x))),
        **TOL)


def test_decodes_and_preprocess_are_jax_s():
    rng = np.random.RandomState(8)
    hm = rng.rand(28, 28, 198).astype(np.float32)
    for a, b in zip(L.decode_landmarks(hm, (3.0, 4.0, 2.0, 1.5)),
                    JL.decode_landmarks(hm, (3.0, 4.0, 2.0, 1.5))):
        np.testing.assert_array_equal(a, b)
    maps = rng.rand(56, 56, 2).astype(np.float32)
    mp = maps.copy()
    mp[::3, ::5, 0] += 0.01
    np.testing.assert_array_equal(
        L.decode_detections(maps, mp, (300, 400), 5, 0.5),
        JL.decode_detections(maps, mp, (300, 400), 5, 0.5))
    np.testing.assert_array_equal(L.logit_arr(hm), JL.logit_arr(hm))
    im = (rng.rand(90, 70, 3) * 255).astype(np.uint8)
    np.testing.assert_array_equal(L.preprocess_crop(im), JL.preprocess_crop(im))
    np.testing.assert_array_equal(L.preprocess_crop(im, 32),
                                  JL.preprocess_crop(im, 32))


@pytest.mark.parametrize("model_type", [0, 3])
def test_landmark_net_from_jax_init_params(model_type):
    """JAX -> port: ``init_landmark_params``' folded pytree."""
    p = JL.init_landmark_params(np.random.RandomState(model_type), model_type)
    x = rand(np.random.RandomState(9), 1, 224, 224, 3)
    want = np.asarray(jax.jit(lambda p, x: JL.apply_landmark_net(
        p, x, model_type))(p, jnp.asarray(x)))
    assert want.std() > 1e-3
    np.testing.assert_allclose(port(C.landmark_net_from_jax(p, model_type), x),
                               want, **TOL)


def test_detection_and_gaze_from_jax():
    rng = np.random.RandomState(10)
    p = JL.convert_torch_detection_model(sd_np(L.seeded_net("detection", 11)))
    x = rand(rng, 1, 224, 224, 3)
    want = jax.jit(JL.apply_detection_net)(p, jnp.asarray(x))
    for g, w in zip(port(C.detection_net_from_jax(p), x), want):
        np.testing.assert_allclose(g, np.asarray(w), **TOL)
    p = JL.convert_torch_gaze_model(sd_np(L.seeded_net("gaze", 12)))
    x = rand(rng, 2, 32, 32, 3)
    np.testing.assert_allclose(
        port(C.gaze_net_from_jax(p), x),
        np.asarray(jax.jit(JL.apply_gaze_net)(p, jnp.asarray(x))), **TOL)


def test_weight_files_load(tmp_path):
    """``.pth`` and ``.npz`` give the same net as the module saved; JAX's
    loader reads the same files; a missing key raises; extra keys (heads
    the reference's file may carry) are ignored."""
    net = L.seeded_net("landmark", 13, 2)
    sd = net.state_dict()
    torch.save(sd, tmp_path / "lm.pth")
    np.savez(tmp_path / "lm.npz", **{k: v.numpy() for k, v in sd.items()})
    x = rand(np.random.RandomState(14), 1, 224, 224, 3)
    want = port(net, x)
    for name in ("lm.pth", "lm.npz"):
        got = port(L.load_landmark_weights(str(tmp_path / name), 2, "cpu"), x)
        np.testing.assert_array_equal(got, want)
        p = JL.load_landmark_weights(str(tmp_path / name), 2)
        np.testing.assert_allclose(got, np.asarray(jax.jit(
            lambda p, x: JL.apply_landmark_net(p, x, 2))(p, jnp.asarray(x))),
            **TOL)
    extra = dict(sd, **{"conv_head.weight": torch.zeros(3)})
    load_reference(L.LandmarkNet(2), extra)
    del extra["bn1.running_var"]
    with pytest.raises(KeyError, match="bn1.running_var"):
        load_reference(L.LandmarkNet(2), extra)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            L.load_landmark_weights(str(tmp_path / "lm.pth"), 2)
