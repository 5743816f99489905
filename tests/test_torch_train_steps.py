"""The stage-1 loss, its raw gradients and whole training steps of the port
against havatar_tpu's ``train/stage1.py``, on the CPU at tiny sizes.

Both sides get the same weights (``from_jax_params``), the same batch and,
for the stochastic cases, JAX's own draws (see tests/test_torch_train.py,
whose helpers this file uses). The JAX side is jitted.
"""

import jax
import numpy as np
import pytest
import torch

from havatar_tpu.train import lpips_jax as JP
from havatar_tpu.train import stage1 as JS1
from havatar_tpu_torch.checkpoints.convert import from_jax_params
from havatar_tpu_torch.train import stage1 as TS1

from test_torch_train import _batch, _cfgs, _stage1_pair, _t, jax_draws


def _assert_grads_close(renderer, jgrads, buffers, rel):
    """Every renderer parameter's raw gradient against JAX's, carried
    through from_jax_params (its layout changes are linear maps). Held per
    tensor to rel * its own largest entry (+1e-7): float32 summation order
    through the generators' deep conv stacks."""
    want = from_jax_params({"params": jgrads, "buffers": buffers})
    named = dict(renderer.named_parameters())
    assert set(named) == set(want) - {
        "headpose_skin_net.canonical_Wvolume.init_lc"}
    checked = 0
    for name, p in named.items():
        w = want[name].numpy()
        g = (torch.zeros_like(p) if p.grad is None else p.grad).numpy()
        np.testing.assert_allclose(
            g, w, atol=rel * float(np.abs(w).max()) + 1e-7, rtol=rel * 10,
            err_msg=name)
        checked += 1
    return checked


@pytest.mark.parametrize("case", ["deterministic_patch", "draws",
                                  "draws_fused_mlp"])
def test_stage1_loss_metrics_and_raw_gradients_match_jax(case):
    """stage1.make_loss_fn on the same batch and weights: the loss, every
    metric (rtol 1e-4; the PSNR atol 1e-3 dB), and the raw gradient of every
    renderer parameter and of the latent codes against jax.grad (per tensor
    to 2e-4 of its largest entry). Raw gradients, not parameters after an
    Adam step: the first Adam step does not depend on a gradient's scale.

    deterministic_patch: no perturbation or noise, 256 rays as a 16 x 16
    patch with the LPIPS term on (random VGG weights carried across).
    draws / draws_fused_mlp: perturb and sigma noise 0.1 on JAX's draws,
    with the plain and with the fused dense chain."""
    over, lp_j, lp_t, R = {}, None, None, 16
    if case == "deterministic_patch":
        over = {"nerf.train.perturb": False,
                "nerf.train.radiance_field_noise_std": 0.0,
                "experiment.patch_rgb": True}
        lp_j = JP.init_lpips_params(jax.random.PRNGKey(9))
        lp_t = jax.tree_util.tree_map(_t, lp_j)
        R = 256
    if case == "draws_fused_mlp":
        over = {"models.use_pallas_mlp": True}
    jc, tc = _cfgs(**over)
    jb, tb = _batch(R=R)
    model, state, tstate = _stage1_pair(jc, tc, jb)
    assert tstate.renderer.model_coarse.use_fused_mlp == (
        case == "draws_fused_mlp")

    key = None if case == "deterministic_patch" else jax.random.PRNGKey(100)
    jloss = JS1.make_loss_fn(model, jc, lp_j)
    (jl, jm), (gp, gl) = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        (state.params, state.latent_codes), state.buffers, jb, key)

    nerf = tc.nerf.train
    noise = None if key is None else jax_draws(key, 2, R, nerf.num_coarse,
                                               nerf.num_fine)
    tl, tm = TS1.make_loss_fn(tstate.renderer, tc, lp_t)(
        tstate.latent_codes, tb, noise)
    tl.backward()

    assert set(tm) == set(jm)
    assert ("patch_percep_loss" in tm) == (case == "deterministic_patch")
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4)
    for k in jm:
        tol = dict(atol=1e-3) if k == "psnr" else dict(rtol=1e-4, atol=1e-7)
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), err_msg=k,
                                   **tol)
    gl = np.asarray(gl)
    np.testing.assert_allclose(tstate.latent_codes.grad.numpy(), gl,
                               atol=2e-4 * np.abs(gl).max(), rtol=2e-3)
    n = _assert_grads_close(tstate.renderer, gp, state.buffers, rel=2e-4)
    assert n > 100


def test_three_train_steps_match_jax():
    """Three steps of make_train_step on both sides from the same state
    (zero Adam moments), each step on its own key's draws, with a learning
    rate that decays by a fifth a step (lr_decay 0.01 kilosteps), so a
    schedule that counted from 1 would show.

    The loss of every step agrees to rtol 2e-4: steps 2 and 3 see the
    parameters the earlier updates made. Parameters after: Adam's first
    steps move every entry by about lr * sign(gradient), whatever the
    gradient's size, so an entry whose true gradient is zero and whose
    computed one is rounding noise (a conv bias in front of an instance
    norm) moves by +-lr on either side, at random; those entries change the
    second and third forward a little, and the total-variation term's
    abs() turns such a change into a jump of a small gradient. Per tensor,
    the entries whose first JAX gradient is at least half the tensor's
    largest must agree to 2% of the three steps' travel (2.4e-5 of 1.2e-3;
    0.3% was seen, and a schedule that counted from 1 would move them by
    20%), and all entries stay within twice that travel."""
    jc, tc = _cfgs(**{"scheduler.lr_decay": 0.01})
    jb, tb = _batch()
    model, state, tstate = _stage1_pair(jc, tc, jb)
    jstep = JS1.make_train_step(model, jc)
    tstep = TS1.make_train_step(tstate, tc)
    g0, _ = jax.jit(jax.grad(JS1.make_loss_fn(model, jc), has_aux=True))(
        (state.params, state.latent_codes), state.buffers, jb,
        jax.random.PRNGKey(200))
    nerf = tc.nerf.train
    lrs = [TS1.learning_rate(tc, i) for i in range(3)]
    np.testing.assert_allclose(lrs, [5e-4 * 0.1 ** (i / 10) for i in range(3)],
                               rtol=1e-6)
    for i in range(3):
        key = jax.random.PRNGKey(200 + i)
        state, jm = jstep(state, jb, key)
        tm = tstep(tb, jax_draws(key, 2, 16, nerf.num_coarse, nerf.num_fine))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=2e-4, err_msg=f"step {i}")
    assert tstate.step == int(state.step) == 3
    travel = sum(lrs)
    want = from_jax_params({"params": state.params,
                            "buffers": state.buffers})
    first = from_jax_params({"params": g0[0], "buffers": state.buffers})
    for name, p in tstate.renderer.named_parameters():
        w, g = want[name].numpy(), np.abs(first[name].numpy())
        d = np.abs(p.detach().numpy() - w)
        assert d.max() <= 2.0 * travel * 1.01, name
        sure = g >= 0.5 * max(float(g.max()), 1e-30)
        if sure.any():
            assert d[sure].max() <= 0.02 * travel, (name, d[sure].max())
    np.testing.assert_allclose(tstate.latent_codes.detach().numpy(),
                               np.asarray(state.latent_codes),
                               atol=0.02 * travel)
