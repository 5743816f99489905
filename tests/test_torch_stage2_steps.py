"""The four stage-2 steps of the port against havatar_tpu's
``train/stage2.py``, on the CPU at tiny sizes, by their raw gradients.

Both sides start from the same weights (``from_jax_params``), take the same
batch and JAX's own draws for the render (tests/test_torch_train.py:
``jax_draws``) and for the generator (``jax_style_draws`` below: the style
codes, the mixing layer, the per-layer noise). The JAX optimizers are
swapped for a transformation that keeps the gradient as its state and moves
nothing, the port's for SGD at rate 0, so each step leaves its raw
gradients behind on both sides. The JAX side is jitted. This file runs the
plain field; tests/test_torch_stage2_quad_steps.py the same steps with
``models.use_pallas_mlp_quad``.

Bounds: metrics rtol 1e-4 (PSNR atol 1e-3 dB); every gradient per tensor
within 2e-4 of its largest entry (+1e-7), as the stage-1 steps are held
(float32 summation order through deep conv stacks, both ways through the
seam between the NeRF and the generator). A thousandth of a tensor's
entries (at least one) may be within 2e-3 instead: a (leaky) ReLU input
within rounding of its kink takes the other slope in one package when the
two renders differ in their last bits, which moves a row of a weight
gradient (``test_torch_stage2.assert_grads_close``).
"""

import functools

import numpy as np
import optax
import pytest
import torch

import torch._dynamo  # noqa: F401  (see tests/test_torch_train.py)

import jax
import jax.numpy as jnp

from havatar_tpu.train import stage2 as JS2
from havatar_tpu_torch.checkpoints.convert import from_jax_params
from havatar_tpu_torch.train import stage2 as TS2

from test_torch_models import _with_random_biases
from test_torch_stage2 import assert_grads_close
from test_torch_train import _cfgs, _t, jax_draws
from test_train_steps import tiny_batch

GEN, RENDER = 64, 16


def _recorder():
    """An optax transformation whose state is the last gradient and whose
    update is zero."""
    zeros = functools.partial(jax.tree_util.tree_map, jnp.zeros_like)
    return optax.GradientTransformation(
        lambda p: zeros(p), lambda g, s, p=None: (zeros(g), g))


def jax_style_draws(key, B, gan, n_latent, noise_res):
    """havatar_tpu's stage-2 sample_styles for the step key ``key`` (its
    second split), as the port's StyleDraws."""
    kz, kmix, kidx, knoise = jax.random.split(jax.random.split(key)[1], 4)
    z = jax.random.normal(kz, (2, B, gan.latent))
    mix = bool(jax.random.uniform(kmix) < gan.mixing)
    idx = int(jax.random.randint(kidx, (), 1, n_latent))
    keys = jax.random.split(knoise, len(noise_res))
    noise = [_t(np.asarray(jax.random.normal(k, (B, r, r, 1)))
                .transpose(0, 3, 1, 2).copy())
             for k, r in zip(keys, noise_res)]
    return TS2.StyleDraws(_t(z[0]), _t(z[1]), idx if mix else n_latent, noise)


def _draws(key, tc, gen):
    nerf = tc.nerf.train
    return TS2.Stage2Draws(
        jax_draws(jax.random.split(key)[0], 2, RENDER * RENDER,
                  nerf.num_coarse, nerf.num_fine),
        jax_style_draws(key, 2, tc.gan, gen.n_latent, gen.noise_res))


def _jax_state(models, jc, jb):
    """havatar_tpu's stage-2 state as ``JS2.init_state`` makes it (its
    modules initialised here under jit: the eager init costs most of a
    minute on the CPU), with the zero-initialized generator and
    discriminator leaves (biases, noise weights) and the latent codes drawn
    from numpy, and recording optimizer states."""
    renderer, generator, discriminator = models
    r_nerf, r_g, r_d = jax.random.split(jax.random.PRNGKey(0), 3)
    B = jb["mv_rays"].shape[0]
    init = jax.jit(functools.partial(renderer.init, num_coarse=4, num_fine=2,
                                     perturb=False))
    variables = init(r_nerf, jb["mv_rays"][..., :8], jb["mv_rays"][..., 8:11],
                     jnp.zeros((B, jc.experiment.latent_code_dim)),
                     jb["inv_head_T"], jb["front_render_cond"],
                     jb["left_render_cond"], jb["right_render_cond"])
    su = jc.models.StyleUnet
    g_vars = jax.jit(generator.init)(
        r_g, jnp.zeros((B, jc.gan.latent)),
        jnp.zeros((B, su.inp_size, su.inp_size, su.inp_ch)))
    d_vars = jax.jit(discriminator.init)(
        r_d, jnp.zeros((B, su.out_size, su.out_size, 3)))
    rng = np.random.RandomState(3)
    g_params = _with_random_biases(g_vars["params"], rng)
    d_params = _with_random_biases(d_vars["params"], rng)
    codes = jnp.asarray(rng.randn(2, jc.experiment.latent_code_dim)
                        .astype(np.float32) * 0.3)
    nerf = variables["params"]
    return JS2.Stage2State(
        step=jnp.zeros((), jnp.int32), nerf_params=nerf,
        nerf_buffers=variables["buffers"], latent_codes=codes,
        g_params=g_params, d_params=d_params, g_ema_params=g_params,
        nerf_opt=_recorder().init((nerf, codes)),
        g_opt=_recorder().init(g_params), d_opt=_recorder().init(d_params))


@functools.lru_cache(maxsize=None)
def _setup(quad: bool):
    """Both packages' stage-2 states on one batch, with recorded / inert
    optimizers, and both packages' four steps."""
    over = {"models.StyleUnet.inp_size": RENDER,
            "models.StyleUnet.out_size": GEN}
    if quad:
        over["models.use_pallas_mlp_quad"] = True
    jc, tc = _cfgs(**over)
    b = tiny_batch(jax.random.PRNGKey(0), R=RENDER * RENDER, gen_size=GEN,
                   render_size=RENDER)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.from_numpy(np.array(v)) for k, v in b.items()}
    models = JS2.build_models(jc)
    state = _jax_state(models, jc, jb)
    real = JS2.make_optimizers
    JS2.make_optimizers = lambda cfg: (_recorder(), _recorder(), _recorder())
    try:
        steps = JS2.make_steps(jc, *models, remat_render=False)
    finally:
        JS2.make_optimizers = real
    g_params = state.g_params

    renderer, gen, disc = TS2.build_models(tc)
    renderer.load_state_dict(from_jax_params(
        {"params": state.nerf_params, "buffers": state.nerf_buffers}))
    gen.load_state_dict(from_jax_params(g_params))
    disc.load_state_dict(from_jax_params(state.d_params))
    tstate = TS2.init_state(tc, 2, "cpu", (renderer, gen, disc))
    with torch.no_grad():
        tstate.latent_codes.copy_(_t(state.latent_codes))
    tstate.nerf_opt = torch.optim.SGD(
        list(renderer.parameters()) + [tstate.latent_codes], lr=0.0)
    tstate.g_opt = torch.optim.SGD(gen.parameters(), lr=0.0)
    tstate.d_opt = torch.optim.SGD(disc.parameters(), lr=0.0)
    assert renderer.model_coarse.use_fused_quad == quad
    return (jc, tc, jb, tb, state, [jax.jit(s) for s in steps], tstate,
            TS2.make_steps(tstate, tc))


def _grads(module):
    return {n: torch.zeros_like(p) if p.grad is None else p.grad
            for n, p in module.named_parameters()}


def _check_metrics(tm, jm):
    assert set(jm) <= set(tm), (set(jm), set(tm))
    for k in jm:
        tol = dict(atol=1e-3) if "psnr" in k else dict(rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), err_msg=k,
                                   **tol)


def _check_nerf_g(tstate, jstate):
    nerf_g, latent_g = jstate.nerf_opt
    want = from_jax_params({"params": nerf_g,
                            "buffers": jstate.nerf_buffers})
    want.pop("headpose_skin_net.canonical_Wvolume.init_lc")
    assert len(want) > 100
    assert_grads_close(_grads(tstate.renderer), want, kinks=True)
    lg = np.asarray(latent_g)
    np.testing.assert_allclose(tstate.latent_codes.grad.numpy(), lg,
                               atol=2e-4 * np.abs(lg).max() + 1e-9,
                               rtol=2e-3)
    assert_grads_close(_grads(tstate.generator),
                       from_jax_params(jstate.g_opt), kinks=True)


def check_step(step: str, quad: bool) -> None:
    """d_step: D's gradient of the weighted logistic loss on a no-grad
    render's fake image; g_step: every NeRF, latent-code and generator
    gradient of the joint objective through the pre-step D; dg_step: all
    three from one shared render, D's on the same detached fake. The step's
    metrics too, and g_ema, which follows G (unmoved here)."""
    jc, tc, jb, tb, state, jsteps, tstate, tsteps = _setup(quad)
    names = ("d_step", "r1_step", "g_step", "dg_step")
    i = names.index(step)
    key = jax.random.PRNGKey(40 + i)
    jstate, jm = jsteps[i](state, jb, key)
    tm = tsteps[i](tb, _draws(key, tc, tstate.generator))
    _check_metrics(tm, jm)
    if step != "g_step":
        assert_grads_close(_grads(tstate.discriminator),
                           from_jax_params(jstate.d_opt), kinks=True)
    if step != "d_step":
        _check_nerf_g(tstate, jstate)
        assert tstate.step == 1
        tstate.step = 0
    assert not any(p.requires_grad for p in tstate.g_ema.parameters())
    torch.testing.assert_close(
        dict(tstate.g_ema.state_dict()), dict(tstate.generator.state_dict()),
        atol=0, rtol=1e-6)


@pytest.mark.parametrize("step", ["d_step", "g_step", "dg_step"])
def test_stage2_step_gradients_match_jax(step):
    """The three rendering steps with the plain field (see check_step);
    tests/test_torch_stage2_quad_steps.py runs them with the quad op."""
    check_step(step, quad=False)


def test_r1_step_gradients_match_jax():
    """r1_step: R1 and D's gradient of (r1/2) R1 weight d_reg_every at the
    real images, a double backward through D."""
    jc, tc, jb, tb, state, jsteps, tstate, tsteps = _setup(False)
    jstate, jm = jsteps[1](state, jb)
    tm = tsteps[1](tb)
    _check_metrics(tm, jm)
    assert_grads_close(_grads(tstate.discriminator),
                       from_jax_params(jstate.d_opt))
