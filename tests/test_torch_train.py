"""Stage-1 training of the port against havatar_tpu, piece by piece, on the
CPU at tiny sizes: compositing with noise, stratified sampling, the
stochastic render, the skinning pretraining, the losses and LPIPS. The loss
as a whole, its gradients and whole training steps are in
tests/test_torch_train_steps.py.

JAX and PyTorch draw different numbers from the same seed, so every
stochastic comparison feeds both sides the same draws: the test computes
JAX's own (``jax.random.split(key, 4)``, then ``uniform`` / ``normal`` at
the shapes ``render_rays`` draws) and hands them to the port as a
``RenderNoise``. Weights cross over through ``from_jax_params``; the JAX
side is jitted and its Pallas kernels run in interpret mode. Tolerances are
stated per test with their reason.
"""

import functools
import json

import numpy as np
import pytest
import torch

# torch imports torch._dynamo on the first optimizer it builds, and that
# import walks importlib specs: it raises if a test file that ran earlier in
# the same process has put a spec-less stand-in module into sys.modules (the
# preprocessing tests do, for onnxruntime). Import it while the test files
# are collected, before any test runs.
import torch._dynamo  # noqa: F401

import jax
import jax.numpy as jnp

from havatar_tpu.models import renderer as JR
from havatar_tpu.models import skinning as JS
from havatar_tpu.ops import grid_sample_3d as j_grid_sample_3d
from havatar_tpu.ops import volume_render as JV
from havatar_tpu.train import losses as JL
from havatar_tpu.train import lpips_jax as JP
from havatar_tpu.train import stage1 as JS1
from havatar_tpu_torch.checkpoints.convert import from_jax_params
from havatar_tpu_torch.models import renderer as TR
from havatar_tpu_torch.models import skinning as TS
from havatar_tpu_torch.ops import volume_render as TV
from havatar_tpu_torch.ops.boxwarp import BoxWarp
from havatar_tpu_torch.train import losses as TL
from havatar_tpu_torch.train import lpips as TP
from havatar_tpu_torch.train import stage1 as TS1
from havatar_tpu_torch.utils.cfgnode import CfgNode as TCfg

import test_torch_renderer as RT
from test_train_steps import tiny_batch, tiny_cfg


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def jax_draws(key, B, R, num_coarse, num_fine, perturb=True, noisy=True):
    """The four draws of havatar_tpu's render_rays for ``key``, as the
    port's RenderNoise."""
    k = jax.random.split(key, 4)
    n_all = (num_coarse + 1) // 2 + num_fine
    return TR.RenderNoise(
        _t(jax.random.uniform(k[0], (B, R, num_coarse))) if perturb else None,
        _t(jax.random.normal(k[1], (B * R, num_coarse))) if noisy else None,
        _t(jax.random.uniform(k[2], (B * R, num_fine))) if perturb else None,
        _t(jax.random.normal(k[3], (B * R, n_all))) if noisy else None)


# ---------------------------------------------------------------------------
# (a) compositing with noise, stratified sampling
# ---------------------------------------------------------------------------

def test_volume_render_with_sigma_noise_matches_jax():
    """volume_render_radiance_field with noise std 0.1 on the same normal
    draws: float32, atol 1e-5 (sums over 12 samples in another order)."""
    rng = np.random.RandomState(0)
    R, S, C = 50, 12, 7
    rad = rng.randn(R, S, C + 1).astype(np.float32)
    z = np.sort(rng.rand(R, S).astype(np.float32) * 3 + 1, -1)
    rd = rng.randn(R, 3).astype(np.float32)
    bg = rng.rand(R, 3).astype(np.float32)
    key = jax.random.PRNGKey(1)
    want = JV.volume_render_radiance_field(
        jnp.asarray(rad), jnp.asarray(z), jnp.asarray(rd),
        radiance_field_noise_std=0.1, background_prior=jnp.asarray(bg),
        noise_rng=key)
    noise = _t(jax.random.normal(key, (R, S)))
    got = TV.volume_render_radiance_field(
        _t(rad), _t(z), _t(rd), _t(bg), radiance_field_noise_std=0.1,
        noise=noise)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-5)
    quiet = TV.volume_render_radiance_field(_t(rad), _t(z), _t(rd), _t(bg))
    assert float((quiet[3] - got[3]).abs().max()) > 1e-3   # the noise acts
    with pytest.raises(ValueError, match="noise"):
        TV.volume_render_radiance_field(_t(rad), _t(z), _t(rd), _t(bg),
                                        radiance_field_noise_std=0.1)


def test_stratified_sample_pdf_matches_jax():
    """sample_pdf(det=False) on the same uniform draws: u = i/n + U (1/n -
    1e-6) through the same CDF. float32, atol 1e-5 on depths in [1, 4]."""
    rng = np.random.RandomState(2)
    R, K, n = 64, 11, 8
    bins = np.sort(rng.rand(R, K).astype(np.float32) * 3 + 1, -1)
    w = rng.rand(R, K - 1).astype(np.float32)
    key = jax.random.PRNGKey(3)
    want = JV.sample_pdf(jnp.asarray(bins), jnp.asarray(w), n, det=False,
                         rng=key)
    u01 = _t(jax.random.uniform(key, (R, n)))
    got = TV.sample_pdf(_t(bins), _t(w), n, det=False, u01=u01)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    assert bool((got[:, 1:] >= got[:, :-1]).all())
    with pytest.raises(ValueError, match="u01"):
        TV.sample_pdf(_t(bins), _t(w), n, det=False)


# ---------------------------------------------------------------------------
# (b) the stochastic render
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fused_mlp", [False, True])
def test_stochastic_render_matches_jax(fused_mlp):
    """render_rays with perturb=True and sigma noise 0.1 on JAX's own draws,
    float32, every output key, with the plain dense chain and with the fused
    one (JAX: use_pallas_mlp, interpret mode; the port's op runs its twin on
    the CPU). The bounds of the deterministic render
    (test_torch_renderer.test_exact_render_matches_jax_xla_path): coarse
    atol 1e-5, fine 5e-5, feature channels and depths 1e-4, rtol 1e-4, one
    fine ray allowed on the inverse CDF's jump; the fused chain sums its
    products in another order than five XLA dots: coarse 2e-5."""
    variables, sc, port = RT._tiny_pair()
    nc, nf = 8, 4
    key = jax.random.PRNGKey(17)
    j = JR.AvatarRenderer(**RT.TINY, use_pallas_mlp=fused_mlp)
    fn = jax.jit(functools.partial(j.apply, num_coarse=nc, num_fine=nf,
                                   perturb=True,
                                   radiance_field_noise_std=0.1))
    want = fn(variables, jnp.asarray(sc["rays"]), jnp.asarray(sc["bg"]),
              jnp.asarray(sc["latent"]), jnp.asarray(sc["inv_T"]),
              *map(jnp.asarray, sc["conds"]), rng=key)
    B, R = sc["rays"].shape[:2]
    noise = jax_draws(key, B, R, nc, nf)
    with torch.no_grad():
        got = port(use_fused_mlp=fused_mlp)(
            *RT._port_args(sc), num_coarse=nc, num_fine=nf, perturb=True,
            radiance_field_noise_std=0.1, rng=noise)
        det = port()(*RT._port_args(sc), num_coarse=nc, num_fine=nf)
    assert float((det["rgb_fine"] - got["rgb_fine"]).abs().max()) > 1e-3
    coarse_tol = 2e-5 if fused_mlp else 1e-5
    for k in RT.OUT_KEYS:
        w, g = np.asarray(want[k]), got[k].numpy()
        assert g.shape == w.shape, k
        fine = k.endswith("fine") or k == "weights_max"
        tight = 5e-5 if fine else coarse_tol
        close = (RT._rays_close if fine else functools.partial(
            RT._rays_close, max_rays=0))
        if k.startswith("rgb"):
            close(g[..., :3], w[..., :3], tight, 1e-4, k)
        atol = 1e-4 if k.startswith(("rgb", "depth")) else tight
        close(g, w, atol, 1e-4, k)


def test_generator_draws_and_render_chunked():
    """A torch.Generator in rng's place: the same seed renders the same
    image, another seed another; draw_render_noise gives the four tensors at
    render_rays' shapes and only those the call needs; render_chunked draws
    per chunk from a generator and refuses ready-made draws."""
    _, sc, port = RT._tiny_pair()
    r = port()
    kw = dict(num_coarse=8, num_fine=4, perturb=True,
              radiance_field_noise_std=0.1)

    def render(seed):
        with torch.no_grad():
            return r(*RT._port_args(sc), rng=torch.Generator().manual_seed(
                seed), **kw)["rgb_fine"]

    torch.testing.assert_close(render(1), render(1), atol=0, rtol=0)
    assert float((render(1) - render(2)).abs().max()) > 1e-4
    n = TR.draw_render_noise(torch.Generator().manual_seed(0), 2, 5, 8, 4,
                             True, 0.1, "cpu")
    assert [tuple(t.shape) for t in n] == [(2, 5, 8), (10, 8), (10, 4),
                                           (10, 8)]
    assert 0.0 <= float(n.coarse_jitter.min()) and float(
        n.coarse_jitter.max()) < 1.0
    n = TR.draw_render_noise(torch.Generator().manual_seed(0), 2, 5, 8, 0,
                             False, 0.1, "cpu")
    assert n.coarse_jitter is None and n.fine_u is None
    assert n.fine_sigma is None and tuple(n.coarse_sigma.shape) == (10, 8)
    with torch.no_grad():
        out = r.render_chunked(*RT._port_args(sc), chunk_size=16,
                               rng=torch.Generator().manual_seed(3), **kw)
        assert out["rgb_fine"].shape == (1, 64, 67)
        with pytest.raises(TypeError, match="Generator"):
            r.render_chunked(*RT._port_args(sc), chunk_size=16,
                             rng=jax_draws(jax.random.PRNGKey(0), 1, 64, 8,
                                           4), **kw)


# ---------------------------------------------------------------------------
# the two packages' stage-1 states side by side (also used by
# tests/test_torch_train_steps.py)
# ---------------------------------------------------------------------------

def _cfgs(**over):
    """tests/test_train_steps.py's tiny config for both packages.
    ``over``: dotted-key overrides, e.g. {"nerf.train.perturb": False}."""
    jc = tiny_cfg()
    for dotted, v in over.items():
        node = jc
        *path, leaf = dotted.split(".")
        for part in path:
            node = node[part]
        node[leaf] = v
    return jc, TCfg(json.loads(json.dumps(jc)))


def _batch(R=16, seed=0):
    b = tiny_batch(jax.random.PRNGKey(seed), R=R)
    keep = ("mv_rays", "gt_color", "dataset_idx", "inv_head_T",
            "front_render_cond", "left_render_cond", "right_render_cond")
    jb = {k: b[k] for k in keep}
    tb = {k: torch.from_numpy(np.asarray(b[k])) for k in keep}
    return jb, tb


def _stage1_pair(jc, tc, jb, latent_scale=0.3):
    """havatar_tpu's fresh stage-1 state (with non-zero latent codes, so the
    code loss is not trivially zero) and the port's state holding it."""
    example = {k: np.asarray(v) for k, v in jb.items()}
    model, state = JS1.init_state(jc, jax.random.PRNGKey(0), num_frames=2,
                                  example_batch=example)
    codes = np.random.RandomState(5).randn(
        *state.latent_codes.shape).astype(np.float32) * latent_scale
    state = state._replace(latent_codes=jnp.asarray(codes))
    tstate = TS1.init_state(tc, 2, "cpu")
    tstate.renderer.load_state_dict(from_jax_params(
        {"params": state.params, "buffers": state.buffers}), strict=True)
    with torch.no_grad():
        tstate.latent_codes.copy_(torch.from_numpy(codes))
    return model, state, tstate


# ---------------------------------------------------------------------------
# (e) skinning pretrain
# ---------------------------------------------------------------------------

def test_pretrain_skinning_matches_jax_and_lowers_the_bce():
    """One pretraining iteration at the same jittered grid points: the loss
    against havatar_tpu's own pretrain_skinning(num_iter=1) history (rtol
    1e-5), the volume decoder's gradients against jax.grad of the same
    composition (per tensor 2e-4 of its largest entry, plus 1e-7: a conv bias
    in front of an instance norm has a true gradient of zero and a computed
    one of rounding noise, about 1e-9 on both sides); 40 iterations of the
    port's own lower the BCE."""
    jc, tc = _cfgs()
    jb, _ = _batch()
    model, state, tstate = _stage1_pair(jc, tc, jb)
    head = jc.models.coarse.Head_bounding
    steps = 6
    key = jax.random.PRNGKey(31)
    _, hist = JS1.pretrain_skinning(model, state.params, state.buffers, key,
                                    head, num_iter=1, steps=steps)
    step_key = jax.random.split(key, 1)[0]
    jitter = jax.random.uniform(step_key, (steps ** 3, 3))

    skin = tstate.renderer.headpose_skin_net
    warp = JS1.BoxWarp(skin.warp.scales, skin.warp.trans)
    thr = jnp.asarray(head, jnp.float32)

    def jloss(skin_p):
        pts = JS.make_volume_pts(steps=steps, rng=step_key, warp=warp)
        inside = jnp.all((pts > thr[:, 0]) & (pts < thr[:, 1]), axis=-1)
        vol = model.apply({"params": dict(state.params, skinning=skin_p),
                           "buffers": state.buffers},
                          method=JR.AvatarRenderer.skin_volume)
        w = jnp.clip(j_grid_sample_3d(vol[..., 1:2], warp(pts)[None],
                                      "border")[0], 0.0, 1.0)
        return JL.binary_cross_entropy(w, inside.astype(jnp.float32)[:, None],
                                       clip=(1e-7, 1 - 1e-7))

    jl, jg = jax.jit(jax.value_and_grad(jloss))(state.params["skinning"])
    loss = TS1.pretrain_loss(tstate.renderer, head, _t(jitter), steps)
    np.testing.assert_allclose(float(loss), float(hist[0]), rtol=1e-5)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    loss.backward()
    want = from_jax_params({"params": {"skinning": jg}, "buffers": {}})
    for name, p in skin.canonical_Wvolume.named_parameters():
        w = want[f"headpose_skin_net.canonical_Wvolume.{name}"].numpy()
        np.testing.assert_allclose(
            p.grad.numpy(), w, atol=2e-4 * np.abs(w).max() + 1e-7,
            rtol=2e-3, err_msg=name)
    others = [p for n, p in tstate.renderer.named_parameters()
              if "canonical_Wvolume" not in n]
    assert all(p.grad is None for p in others)

    before = [p.detach().clone() for p in others]
    hist_t = TS1.pretrain_skinning(tstate.renderer,
                                   torch.Generator().manual_seed(0), head,
                                   num_iter=40, steps=steps)
    assert len(hist_t) == 40 and np.isfinite(hist_t).all()
    assert np.mean(hist_t[-5:]) < 0.8 * np.mean(hist_t[:5])
    assert all(torch.equal(a, b) for a, b in zip(before, others))


# ---------------------------------------------------------------------------
# (f) losses and LPIPS, (g) small pieces
# ---------------------------------------------------------------------------

def test_losses_match_jax_function_by_function():
    """train/losses.py against havatar_tpu/train/losses.py on seeded inputs:
    float32, rtol 1e-5 / atol 1e-6 (the same elementwise formulas)."""
    rng = np.random.RandomState(0)

    def close(got, want, **kw):
        np.testing.assert_allclose(np.asarray(got, np.float32),
                                   np.asarray(want, np.float32),
                                   **(kw or dict(rtol=1e-5, atol=1e-6)))

    close(TL.mse2psnr(3e-3), JL.mse2psnr(3e-3))
    close(TL.mse2psnr(_t([0.0, 1e-13, 0.5])),
          JL.mse2psnr(jnp.asarray([0.0, 1e-13, 0.5])))
    p = rng.rand(40, 1).astype(np.float32) * 1.2 - 0.1
    t = (rng.rand(40, 1) > 0.5).astype(np.float32)
    close(TL.binary_cross_entropy(_t(p), _t(t)),
          JL.binary_cross_entropy(jnp.asarray(p), jnp.asarray(t)))
    close(TL.binary_cross_entropy(_t(p), _t(t), clip=(1e-7, 1 - 1e-7)),
          JL.binary_cross_entropy(jnp.asarray(p), jnp.asarray(t),
                                  clip=(1e-7, 1 - 1e-7)))
    v = rng.rand(6, 7, 8).astype(np.float32)
    close(TL.skin_weight_tv_loss(_t(v)),
          JL.skin_weight_tv_loss(jnp.asarray(v)))
    for step in (0, 1, 1000, 250000, 10 ** 7):
        close(TL.stage1_lr(step, 5e-4), JL.stage1_lr(step, 5e-4), rtol=1e-6)
        close(TL.gan_loss_weight(step), JL.gan_loss_weight(jnp.asarray(step)),
              rtol=1e-5)
    close(TL.stage1_lr(torch.tensor(1234.0), 5e-4, 0.5, 3, 1e-5),
          JL.stage1_lr(1234.0, 5e-4, 0.5, 3, 1e-5), rtol=1e-6)
    close(TL.gan_loss_weight(torch.tensor(26000)),
          JL.gan_loss_weight(jnp.asarray(26000)), rtol=1e-5)
    img = rng.rand(2, 9, 9, 3).astype(np.float32)
    got = TL.downsample_bilinear(_t(img), 4)
    close(got, JL.downsample_bilinear(jnp.asarray(img), 4))
    ref = torch.nn.functional.interpolate(
        _t(img).permute(0, 3, 1, 2), size=4, mode="bilinear",
        align_corners=True).permute(0, 2, 3, 1)
    close(got, ref)
    a, b = rng.randn(5, 1).astype(np.float32), rng.randn(5, 1).astype(
        np.float32)
    close(TL.d_logistic_loss(_t(a), _t(b)),
          JL.d_logistic_loss(jnp.asarray(a), jnp.asarray(b)))
    close(TL.g_nonsaturating_loss(_t(a)),
          JL.g_nonsaturating_loss(jnp.asarray(a)))

    # R1 of a small differentiable score, and its gradient to the score's
    # own weight (the double backward stage 2 needs)
    w = rng.randn(3).astype(np.float32)
    real = rng.randn(4, 5, 5, 3).astype(np.float32)

    def j_apply(params, x):
        return jnp.sum(jnp.tanh(x) * params, axis=(1, 2, 3))

    want = JL.d_r1_penalty(j_apply, jnp.asarray(w), jnp.asarray(real))
    want_g = jax.grad(lambda pw: JL.d_r1_penalty(j_apply, pw,
                                                 jnp.asarray(real)))(
        jnp.asarray(w))
    tw = _t(w).requires_grad_()
    got = TL.d_r1_penalty(lambda x: (torch.tanh(x) * tw).sum((1, 2, 3)),
                          _t(real))
    close(got.detach(), want)
    close(torch.autograd.grad(got, tw)[0], want_g, rtol=1e-4, atol=1e-5)

    lg = rng.randn(3, 4, 6).astype(np.float32)
    got = TL.g_path_regularize(None, _t(lg), torch.tensor(0.7))
    want = JL.g_path_regularize(None, jnp.asarray(lg), jnp.asarray(0.7))
    for g, w_ in zip(got, want):
        close(g, w_)


def test_lpips_matches_jax_with_carried_weights(tmp_path):
    """lpips / lpips_loss with init_lpips_params' random weights carried
    across, 16 x 16 images: rtol 2e-4 (13 conv layers of up to 4608-term
    sums in another order). The .npz that havatar_tpu saves loads here
    without JAX, the one saved here loads there, and convert_torch_lpips
    lays torchvision-style tensors out the same as the JAX converter."""
    rng = np.random.RandomState(1)
    jp = JP.init_lpips_params(jax.random.PRNGKey(4))
    tp = jax.tree_util.tree_map(_t, jp)
    a = rng.rand(2, 16, 16, 3).astype(np.float32)
    b = rng.rand(2, 16, 16, 3).astype(np.float32)
    want = float(jax.jit(JP.lpips_loss)(jp, jnp.asarray(a), jnp.asarray(b)))
    got = float(TP.lpips_loss(tp, _t(a), _t(b)))
    assert want > 0
    np.testing.assert_allclose(got, want, rtol=2e-4)
    np.testing.assert_allclose(
        float(TP.lpips(tp, _t(a) * 2 - 1, _t(b) * 2 - 1)), want, rtol=2e-4)
    assert float(TP.lpips_loss(tp, _t(a), _t(a))) == 0.0

    path = str(tmp_path / "lpips.npz")
    JP.save_lpips_file(jp, path)
    loaded = TP.load_lpips_file(path)
    np.testing.assert_allclose(float(TP.lpips_loss(loaded, _t(a), _t(b))),
                               got, rtol=1e-6)
    assert TP.load_lpips_file(str(tmp_path / "absent.npz")) is None
    path2 = str(tmp_path / "lpips_port.npz")
    TP.save_lpips_file(tp, path2)
    back = JP.load_lpips_file(path2)
    np.testing.assert_allclose(
        float(JP.lpips_loss(back, jnp.asarray(a), jnp.asarray(b))), want,
        rtol=1e-6)

    own = TP.init_lpips_params(torch.Generator().manual_seed(0))
    assert jax.tree_util.tree_structure(own) == jax.tree_util.tree_structure(
        jax.tree_util.tree_map(np.asarray, jp))
    assert all(tuple(x.shape) == y.shape for x, y in zip(
        jax.tree_util.tree_leaves(own), jax.tree_util.tree_leaves(jp)))

    idx = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]
    chans = [3, 64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512, 512]
    vgg = {}
    for n, layer in enumerate(idx):
        vgg[f"features.{layer}.weight"] = _t(rng.randn(chans[n + 1],
                                                       chans[n], 3, 3))
        vgg[f"features.{layer}.bias"] = _t(rng.randn(chans[n + 1]))
    lin = {f"lin{i}.model.1.weight": _t(rng.rand(1, c, 1, 1))
           for i, c in enumerate((64, 128, 256, 512, 512))}
    conv_t = TP.convert_torch_lpips(vgg, lin)
    conv_j = JP.convert_torch_lpips(vgg, lin)
    for x, y in zip(jax.tree_util.tree_leaves(conv_t),
                    jax.tree_util.tree_leaves(conv_j)):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))


def test_latent_code_loss_and_make_volume_pts_match_jax():
    """latent_code_loss (value and gradient: the mean code is a constant)
    and make_volume_pts (plain, jittered with JAX's draws, un-warped):
    float32, atol 1e-6."""
    rng = np.random.RandomState(2)
    codes = rng.randn(5, 8).astype(np.float32)
    idx = np.array([3, 1])
    want, want_g = jax.value_and_grad(
        lambda c: JR.latent_code_loss(c, c[idx]))(jnp.asarray(codes))
    tc = _t(codes).requires_grad_()
    got = TR.latent_code_loss(tc, tc[torch.from_numpy(idx)])
    got.backward()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    np.testing.assert_allclose(tc.grad.numpy(), np.asarray(want_g),
                               atol=1e-6)

    scales, trans = (0.7, 0.9, 0.8), (0.0, -0.2, 0.1)
    key = jax.random.PRNGKey(6)
    jitter = _t(jax.random.uniform(key, (5 ** 3, 3)))
    for kw_j, kw_t in (
            (dict(), dict()),
            (dict(rng=key), dict(jitter=jitter)),
            (dict(rng=key, warp=JS1.BoxWarp(scales, trans)),
             dict(jitter=jitter, warp=BoxWarp(scales, trans)))):
        want = JS.make_volume_pts(steps=5, **kw_j)
        got = TS.make_volume_pts(steps=5, **kw_t)
        assert got.shape == (125, 3)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
