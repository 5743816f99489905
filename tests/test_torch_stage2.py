"""Stage-2 networks of the port against havatar_tpu, on the CPU at the tiny
sizes of tests/configs/tiny_hd.yml (512^2 -> 64^2 images, channel
multiplier 1): the minibatch-stddev channel, the wavelet discriminator's
scores and R1 penalty with its parameter gradients (a double backward), the
StyleUNet generator with style mixing and per-layer noise on JAX's own
draws, the EMA update and the discriminator's state_dict round trip.

Weights: the JAX modules' own initialization with every zero-initialized
leaf replaced by numpy normals, carried across by ``from_jax_params``. The
JAX side is jitted. Tolerances: convolutions 1e-4 absolute and relative
(tests/test_torch_models.py); gradients per tensor within 2e-4 of the
tensor's largest entry (float32 summation order through a deep conv stack).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from havatar_tpu.checkpoints import convert as JC
from havatar_tpu.models import blocks as JB
from havatar_tpu.models import discriminator as JD
from havatar_tpu.models import generators as JG
from havatar_tpu.train import ema as JE
from havatar_tpu.train import losses as JL
from havatar_tpu_torch.checkpoints import convert as TC
from havatar_tpu_torch.models import blocks as TB
from havatar_tpu_torch.models import discriminator as TD
from havatar_tpu_torch.models import generators as TG
from havatar_tpu_torch.train import ema as TE
from havatar_tpu_torch.train import losses as TL

from test_torch_models import (CONV_TOL, _assert_trees_equal, _close, _init,
                               _load, _nchw)

D_KW = dict(size=64, channel_multiplier=1)
G_KW = dict(inp_size=16, inp_ch=16, out_ch=3, out_size=64, style_dim=16,
            n_mlp=2, middle_size=8, channel_multiplier=1)


def assert_grads_close(named_grads, want_sd, rel=2e-4, kinks=False):
    """Each port gradient against the JAX gradient carried through
    from_jax_params (a linear map of each leaf), per tensor to ``rel`` of
    its largest entry (+1e-7). With ``kinks``, a thousandth of a tensor's
    entries (at least one) may miss that and stay within 10 * rel: where a
    (leaky) ReLU's input lies within rounding of its kink, the two packages
    can take its two slopes, which moves one row of a weight gradient or
    one term of a bias gradient's sum."""
    assert set(named_grads) == set(want_sd)
    for name, g in named_grads.items():
        w, g = want_sd[name].numpy(), g.numpy()
        scale = float(np.abs(w).max())
        err = np.abs(g - w) - rel * 10 * np.abs(w)
        allowed = max(1, w.size // 1000) if kinks else 0
        assert int((err > rel * scale + 1e-7).sum()) <= allowed, (
            name, float(err.max()), scale)
        np.testing.assert_allclose(g, w, atol=10 * rel * scale + 1e-7,
                                   rtol=rel * 10, err_msg=name)


@pytest.mark.parametrize("B,feat", [(4, 1), (2, 2), (8, 1)])
def test_minibatch_stddev_matches_jax(B, feat):
    """[B, C, H, W] -> [B, C + F, H, W], groups of min(B, 4); float32,
    atol 1e-6."""
    x = np.random.RandomState(B).randn(B, 6, 5, 4).astype(np.float32)
    want = JB.minibatch_stddev(jnp.asarray(x), 4, feat)
    got = TB.minibatch_stddev(_nchw(x), 4, feat)
    _close(got, want, atol=1e-6, rtol=1e-6)


def _discriminator_pair(seed=1):
    rng = np.random.RandomState(seed)
    img = rng.rand(2, 64, 64, 3).astype(np.float32)
    j = JD.WaveletDiscriminator(**D_KW)
    v = _init(j, rng, jnp.asarray(img))
    t = _load(TD.WaveletDiscriminator(**D_KW), TC.from_jax_params(v))
    return j, v, t, img


def test_discriminator_scores_and_r1_match_jax():
    """D(x) (atol/rtol 1e-4) and the R1 penalty at the same real images
    with its gradient to every discriminator parameter (a double backward
    through every op of D) against jax.grad of havatar_tpu's
    d_r1_penalty: R1 rtol 1e-4, gradients per tensor 2e-4 of the largest
    entry. The port's state_dict reads back through convert_discriminator
    unchanged."""
    j, v, t, img = _discriminator_pair()
    want = jax.jit(j.apply)(v, jnp.asarray(img))
    got = t(_nchw(img))
    assert got.shape == (2, 1) and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **CONV_TOL)

    def r1(params, x):
        return JL.d_r1_penalty(lambda p, im: j.apply({"params": p}, im),
                               params, x)

    jr1, jgrads = jax.jit(jax.value_and_grad(r1))(v["params"],
                                                  jnp.asarray(img))
    tr1 = TL.d_r1_penalty(t, _nchw(img))
    tr1.backward()
    np.testing.assert_allclose(float(tr1.detach()), float(jr1), rtol=1e-4)
    assert float(tr1.detach()) > 0
    # the last bias does not reach the input gradient: no .grad, zero in JAX
    assert_grads_close({n: torch.zeros_like(p) if p.grad is None else p.grad
                        for n, p in t.named_parameters()},
                       TC.from_jax_params(jgrads))
    back = JC.convert_discriminator(t.state_dict(), size=64)
    _assert_trees_equal(back, v["params"])


def _noise_draws(key, t, B):
    """havatar_tpu's per-StyledConv noise for ``noise_rng=key``: one split
    a layer, a normal [B, r, r, 1] each; as NHWC arrays and NCHW tensors."""
    keys = jax.random.split(key, len(t.noise_res))
    nhwc = [jax.random.normal(k, (B, r, r, 1))
            for k, r in zip(keys, t.noise_res)]
    return [_nchw(n) for n in nhwc]


@pytest.mark.parametrize("inject", [None, 3])
def test_styleunet_mixing_and_noise_match_jax(inject):
    """StyleUNetSR with two styles (inject index 3, or the default
    n_latent // 2) and noise in every StyledConv, the noise tensors being
    JAX's own draws for its noise_rng: CONV_TOL. The noise acts (the output
    moves without it), and so does the mixing."""
    rng = np.random.RandomState(6)
    B = 2
    z0, z1 = (rng.randn(B, 16).astype(np.float32) for _ in range(2))
    cond = rng.randn(B, 16, 16, 16).astype(np.float32)
    j = JG.StyleUNetSR(**G_KW)
    v = _init(j, rng, jnp.asarray(z0), jnp.asarray(cond))
    t = _load(TG.StyleUNetSR(**G_KW), TC.from_jax_params(v))
    assert t.n_latent == j.n_latent
    key = jax.random.PRNGKey(4)
    kw = {} if inject is None else {"inject_index": inject}
    want = jax.jit(functools.partial(j.apply, **kw))(
        v, [jnp.asarray(z0), jnp.asarray(z1)], jnp.asarray(cond),
        noise_rng=key)
    noise = _noise_draws(key, t, B)
    assert [tuple(n.shape) for n in noise] == t.noise_shapes(B)
    with torch.no_grad():
        args = ([torch.from_numpy(z0), torch.from_numpy(z1)], _nchw(cond))
        got = t(*args, noise=noise, inject_index=inject)
        _close(got, want)
        quiet = t(*args, inject_index=inject)
        single = t(torch.from_numpy(z0), _nchw(cond), noise=noise)
    assert float((quiet - got).abs().max()) > 1e-3
    assert float((single - got).abs().max()) > 1e-3
    drawn = t.draw_noise(B, torch.Generator().manual_seed(0), "cpu")
    assert [tuple(n.shape) for n in drawn] == t.noise_shapes(B)


def test_ema_update_matches_jax():
    """ema <- ema * d + p * (1 - d) for every parameter, in place: atol
    1e-7 against havatar_tpu's ema_update on the same trees."""
    torch.manual_seed(0)
    a, b = TD.WaveletDiscriminator(**D_KW), TD.WaveletDiscriminator(**D_KW)
    decay = 0.5 ** (32 / 10000)
    want = JE.ema_update(
        [p.detach().numpy().copy() for p in a.parameters()],
        [p.detach().numpy() for p in b.parameters()], decay)
    TE.ema_update(a, b, decay)
    for p, w in zip(a.parameters(), want):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(w),
                                   atol=1e-7)
