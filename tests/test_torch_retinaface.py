"""havatar_tpu_torch.preprocess.retinaface against havatar_tpu's on the CPU.

The numpy stages (prior boxes, decode, NMS) must be JAX's exactly. A seeded
port ``RetinaFace`` (mobilenet0.25 widths) gives its ``state_dict()`` to
JAX's ``convert_torch_retinaface``; on a small input the two nets' loc must
agree within JAX's own test bound (atol 2e-4, rtol 1e-3) and conf within
atol 1e-5, and ``retinaface_from_jax`` must rebuild the net from JAX's
folded params. The detector drivers, port and JAX, on the same seeded net
and frame return the same boxes; a driver with a planted anchor returns the
box the reference's margin arithmetic gives.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from havatar_tpu.preprocess import retinaface as JR
from havatar_tpu_torch.checkpoints.convert import retinaface_from_jax
from havatar_tpu_torch.preprocess import retinaface as R
from havatar_tpu_torch.preprocess.nets import seed_

LOC_TOL = dict(atol=2e-4, rtol=1e-3)
CONF_TOL = dict(atol=1e-5, rtol=1e-4)


@pytest.fixture(scope="module")
def nets():
    net = seed_(R.RetinaFace(), 0)
    params = JR.convert_torch_retinaface(
        {k: v.numpy() for k, v in net.state_dict().items()})
    return net, params


def test_priorbox_decode_nms_are_jax_s():
    for res in ((640, 640), (320, 240)):
        np.testing.assert_array_equal(R.make_priorbox(res),
                                      JR.make_priorbox(res))
    rng = np.random.RandomState(1)
    priors = R.make_priorbox()[:700]
    loc = rng.randn(700, 4).astype(np.float32) * 0.5
    np.testing.assert_array_equal(R.decode_boxes(loc.copy(), priors),
                                  JR.decode_boxes(loc.copy(), priors))
    xy = rng.rand(300, 2) * 400
    dets = np.hstack([xy, xy + rng.rand(300, 2) * 120 + 10,
                      rng.rand(300, 1)]).astype(np.float32)
    for thresh in (0.3, 0.4, 0.7):
        assert R.nms(dets.copy(), thresh) == JR.nms(dets.copy(), thresh)


def test_net_matches_jax_both_ways(nets):
    net, params = nets
    x = np.random.RandomState(2).randn(2, 96, 80, 3).astype(np.float32) * 50
    want = jax.jit(JR.apply_retinaface)(params, jnp.asarray(x))
    for module in (net, retinaface_from_jax(params)):
        with torch.no_grad():
            loc, conf = module(torch.from_numpy(x).permute(0, 3, 1, 2))
        assert loc.shape == (2, len(R.make_priorbox((80, 96))), 4)
        np.testing.assert_allclose(loc.numpy(), np.asarray(want[0]), **LOC_TOL)
        np.testing.assert_allclose(conf.numpy(), np.asarray(want[1]),
                                   **CONF_TOL)


def test_upsample_nearest_is_the_integer_index():
    """floor(i * H / oh) at a ratio that is not an integer (5 -> 13)."""
    x = np.random.RandomState(3).randn(1, 2, 5, 7).astype(np.float32)
    got = R.upsample_nearest(torch.from_numpy(x), (13, 9)).numpy()
    want = JR._upsample_nearest(jnp.asarray(x.transpose(0, 2, 3, 1)), (13, 9))
    np.testing.assert_array_equal(got, np.asarray(want).transpose(0, 3, 1, 2))


def test_detector_matches_jax(nets):
    """Both drivers, at 640^2, on one seeded net and a 240 x 320 frame; the
    score threshold (the seeded net's 99.5th percentile score on the frame)
    keeps about 80 anchors for the NMS."""
    net, params = nets
    frame = (np.random.RandomState(4).rand(240, 320, 3) * 255).astype(np.uint8)
    seen = []
    det = R.RetinaFaceDetector(lambda x: seen.append(net(x)) or seen[-1],
                               min_conf=1.0, device="cpu")
    assert det.detect(frame) == []
    thr = float(np.quantile(seen[0][1][0, :, 1].numpy(), 0.995))
    det = R.RetinaFaceDetector(net, min_conf=thr, top_k=5, device="cpu")
    jdet = JR.JaxRetinaFaceDetector(params, min_conf=thr, top_k=5)
    got, want = det.detect(frame), jdet.detect(frame)
    assert len(got) == len(want) == 5
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-2)


def test_detector_decodes_a_planted_anchor():
    """A net whose one confident anchor is ``idx``: the (x, y, w, h) box is
    the prior's, grown by the (0.15, 0.2) margins, in frame pixels."""
    priors = R.make_priorbox()
    idx = 5000

    def fake(x):
        loc = torch.zeros(1, len(priors), 4)
        conf = torch.full((1, len(priors), 2), 0.01)
        conf[0, idx, 1] = 0.95
        return loc, conf

    out = R.RetinaFaceDetector(fake, device="cpu").detect(
        np.zeros((480, 640, 3), np.uint8))
    assert len(out) == 1
    x, y, w, h = out[0]
    cx, cy, pw, ph = priors[idx]
    bw, bh = pw * 640, ph * 480
    np.testing.assert_allclose([w, h], [bw * 1.3, bh * 1.4], rtol=1e-5)
    np.testing.assert_allclose([x, y], [cx * 640 - bw / 2 - 0.15 * bw,
                                        cy * 480 - bh / 2 - 0.2 * bh],
                               rtol=1e-4)
