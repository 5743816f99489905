"""The fused quad field op (``ops/mlp_quad.py:field_radiance_quad``) against
havatar_tpu's ``ops/pallas_mlp_quad.py:field_radiance_quad`` in interpret
mode, on the CPU, where the port's op runs its plain twins; and a stage-1
step with ``models.use_pallas_mlp_quad`` against havatar_tpu's.

Inputs come from tests/test_pallas_mlp_quad.py's ``setup_case`` (JAX
normals at fixed keys), carried to torch as numpy arrays. Bounds are that
file's own: forward rtol/atol 1e-5, every gradient (both planes, the
points through the corner weights, the posenc, all ten parameters) 1e-4.
bfloat16 planes: the two packages round the reduced input and the hidden
activations to bf16 in the same places but sum in other orders, so a value
can land on the other bf16 neighbour: relative L2 2e-2.
"""

import functools

import numpy as np
import pytest
import torch

import torch._dynamo  # noqa: F401  (see tests/test_torch_train.py)

import jax
import jax.numpy as jnp

from havatar_tpu.ops import pallas_mlp_quad as JQ
from havatar_tpu.train import stage1 as JS1
from havatar_tpu_torch.checkpoints.convert import from_jax_params
from havatar_tpu_torch.ops import mlp_quad as Q
from havatar_tpu_torch.train import stage1 as TS1

from test_pallas_mlp_quad import setup_case
from test_torch_stage2 import assert_grads_close
from test_torch_train import _batch, _cfgs, jax_draws

LAYERS = ("layer0", "layer1", "fc_rgbFeat", "fc_alpha", "fc_rgb")


def _torch_params(prm):
    """JAX Dense params -> the op's ten Linear tensors (weights [out, in])."""
    out = []
    for n in LAYERS:
        out.append(torch.from_numpy(np.array(prm[n]["kernel"]).T.copy()))
        out.append(torch.from_numpy(np.array(prm[n]["bias"])))
    return [p.requires_grad_() for p in out]


def _jax_grads_as_torch(gp):
    out = []
    for n in LAYERS:
        out += [np.asarray(gp[n]["kernel"]).T, np.asarray(gp[n]["bias"])]
    return out


@functools.lru_cache(maxsize=None)
def _jax_case(N, seed, padding, dtype):
    """havatar_tpu's op on setup_case: output and the gradients of
    sum(out * cot) (jitted, interpret mode)."""
    pxy, pzy, w, pe, prm, cot = setup_case(N=N, seed=seed)
    pxy, pzy = pxy.astype(dtype), pzy.astype(dtype)

    def loss(a, b, c, d, p):
        out = JQ.field_radiance_quad(padding, True, 32, a, b, c, d, p)
        return jnp.sum(out * cot), out

    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2, 3, 4), has_aux=True))(pxy, pzy, w, pe, prm)
    return (pxy, pzy, w, pe, prm, cot), out, grads


def _port(inputs, padding, sorted_scatter=False):
    pxy, pzy, w, pe, prm, cot = inputs
    t = [torch.from_numpy(np.array(a, np.float32)).requires_grad_()
         for a in (pxy, pzy, w, pe)]
    dt = torch.bfloat16 if pxy.dtype == jnp.bfloat16 else torch.float32
    planes = [p.detach().to(dt).requires_grad_() for p in t[:2]]
    params = _torch_params(prm)
    out = Q.field_radiance_quad(*planes, t[2], t[3], *params,
                                padding_mode=padding,
                                sorted_scatter=sorted_scatter)
    (out * torch.from_numpy(np.asarray(cot))).sum().backward()
    grads = [planes[0].grad, planes[1].grad, t[2].grad, t[3].grad,
             *[p.grad for p in params]]
    return out.detach(), [g.float().numpy() for g in grads]


def _want_list(jgrads):
    return ([np.asarray(g, np.float32) for g in jgrads[:4]]
            + _jax_grads_as_torch(jgrads[4]))


@pytest.mark.parametrize("N,padding,sorted_scatter", [
    (97, "zeros", False), (131, "zeros", True), (64, "border", False)])
def test_op_matches_jax_float32(N, padding, sorted_scatter):
    """Forward and all gradients, float32, at a ragged N (97: no tile of
    32 divides it), at 131 with the sorted splat, and with border padding
    (the corner weights' clip)."""
    inputs, want, jgrads = _jax_case(N, 3, padding, jnp.float32)
    got, grads = _port(inputs, padding, sorted_scatter)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    names = ["plane_xy", "plane_zy", "warped", "pe"] + [
        f"{n}.{k}" for n in LAYERS for k in ("weight", "bias")]
    for name, g, w in zip(names, grads, _want_list(jgrads)):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4, err_msg=name)


def test_op_matches_jax_bfloat16():
    """bf16 planes (the --bf16 / --turbo path): forward and every gradient
    by relative L2, 2e-2; the gradients of the planes come back in bf16."""
    inputs, want, jgrads = _jax_case(97, 5, "zeros", jnp.bfloat16)
    got, grads = _port(inputs, "zeros")

    def rel(a, b):
        return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))

    assert rel(got.numpy(), np.asarray(want)) < 2e-2
    for i, (g, w) in enumerate(zip(grads, _want_list(jgrads))):
        assert rel(g, w) < 2e-2, (i, rel(g, w))


def test_kernel_halves_twins_and_double_backward():
    """quad_forward / quad_backward on CPU tensors are the twins: the
    forward twin differentiated by autograd gives the backward twin's plane
    gradients, daux and parameter gradients (atol 1e-5); the op refuses a
    second differentiation; inputs that are not planes [H, W, C], rows
    [N, 2] and aux [N, n_pe + 8] raise."""
    rng = np.random.RandomState(0)
    N, C, n_pe, H, W = 50, 8, 12, 9, 7
    planes = [torch.from_numpy(rng.randn(H, W, C).astype(np.float32))
              for _ in range(2)]
    rows = torch.from_numpy(np.stack(
        [rng.randint(0, (H - 1) * (W - 1), N) for _ in range(2)], 1)
        .astype(np.int32))
    aux = torch.from_numpy(rng.rand(N, n_pe + 8).astype(np.float32))
    g = torch.from_numpy(rng.randn(N, 20).astype(np.float32))
    _, _, _, _, prm, _ = setup_case(N=N, C=C, n_pe=n_pe)
    params = _torch_params(prm)
    leaves = [t.requires_grad_() for t in (*planes, aux)]
    out = Q.quad_forward(*planes, rows, aux, *params)
    assert not out.requires_grad and out.shape == (N, 20)
    want = torch.autograd.grad(
        Q.field_radiance_quad_plain(*planes, rows, aux, *params),
        (*leaves, *params), g)
    dxy, dzy, daux, grads = Q.quad_backward(*planes, rows, aux, g, *params)
    for a, b in zip((dxy, dzy, daux, *grads), want):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)

    pxy, pzy, w, pe, prm, _ = setup_case(N=N)
    planes = [torch.from_numpy(np.array(p)).requires_grad_()
              for p in (pxy, pzy)]
    out = Q.field_radiance_quad(*planes, torch.from_numpy(np.array(w)),
                                torch.from_numpy(np.array(pe)),
                                *_torch_params(prm))
    (d,) = torch.autograd.grad(out.sum(), planes[0], create_graph=True)
    with pytest.raises(RuntimeError):
        d.sum().backward()
    with pytest.raises(ValueError, match="rows"):
        Q.quad_forward(planes[0], planes[1], rows[:, :1], aux, *params)
    with pytest.raises(ValueError, match="planes"):
        Q.quad_forward(planes[0], planes[1][:-1], rows, aux, *params)


@pytest.mark.parametrize("padding", ["zeros", "border"])
def test_kernel_halves_match_jax(padding):
    """The kernel halves' twins at the kernels' contract (planes, rows from
    ``quad_rows``, aux = posenc ++ w8, cotangent) against havatar_tpu's op
    in interpret mode at a ragged N: the output (1e-5) and the gradients of
    both planes, the posenc and all ten parameters (1e-4)."""
    inputs, want, jgrads = _jax_case(97, 3, padding, jnp.float32)
    pxy, pzy, w, pe, prm, cot = inputs
    planes = [torch.from_numpy(np.array(p, np.float32)) for p in (pxy, pzy)]
    H, W, _ = planes[0].shape
    rows, w8 = Q.quad_rows(torch.from_numpy(np.array(w)), H, W, padding)
    assert rows.dtype == torch.int32 and rows.shape == (97, 2)
    aux = torch.cat([torch.from_numpy(np.array(pe)), w8], -1)
    params = [p.detach() for p in _torch_params(prm)]
    out = Q.quad_forward(*planes, rows, aux, *params)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    dxy, dzy, daux, grads = Q.quad_backward(
        *planes, rows, aux, torch.from_numpy(np.asarray(cot)), *params)
    got = [dxy, dzy, daux[:, :pe.shape[1]], *grads]
    want_g = _want_list(jgrads)
    for i, (a, b) in enumerate(zip(got, want_g[:2] + want_g[3:])):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=1e-4,
                                   err_msg=str(i))


def _gather_by_index(pxy, pzy, rows):
    """Each point's 4 + 4 corner texels by plain indexing (differentiable),
    independent of the quad table: [N, 8C]."""
    W = pxy.shape[1]
    out = []
    for p, plane in enumerate((pxy, pzy)):
        q = rows[:, p].long()
        y0, x0 = q // (W - 1), q % (W - 1)
        out += [plane[y0 + dy, x0 + dx] for dy in (0, 1) for dx in (0, 1)]
    return torch.cat(out, 1)


@pytest.mark.parametrize("N,padding,dtype,sorted_scatter", [
    (97, "zeros", torch.float32, False), (64, "border", torch.float32, True),
    (131, "zeros", torch.bfloat16, False),
    (45, "border", torch.bfloat16, True)])
def test_twins_match_the_composition(N, padding, dtype, sorted_scatter):
    """The twins at the new contract against the composition they replace:
    the corner texels gathered by plain indexing, the chain on them
    (``quad_chain_plain`` / ``quad_chain_bwd_plain``) and, for the plane
    gradients, autograd's adjoint of that gather. Forward, daux and the
    parameter gradients bit for bit; the plane gradients (a sum in another
    order) to 1e-5."""
    pxy, pzy, w, pe, prm, cot = setup_case(N=N, seed=7)
    planes = [torch.from_numpy(np.array(p)).to(dtype) for p in (pxy, pzy)]
    H, W, _ = planes[0].shape
    rows, w8 = Q.quad_rows(torch.from_numpy(np.array(w)), H, W, padding)
    aux = torch.cat([torch.from_numpy(np.array(pe)), w8], -1)
    g = torch.from_numpy(np.asarray(cot))
    params = [p.detach() for p in _torch_params(prm)]
    quads = _gather_by_index(*planes, rows)
    assert torch.equal(Q.gather_rows(*planes, rows), quads)
    out = Q.field_radiance_quad_plain(*planes, rows, aux, *params)
    assert torch.equal(out, Q.quad_chain_plain(quads, aux, *params))
    dxy, dzy, daux, grads = Q.field_radiance_quad_bwd_plain(
        *planes, rows, aux, g, *params, sorted_scatter=sorted_scatter)
    dq, w_daux, w_grads = Q.quad_chain_bwd_plain(quads, aux, g, *params)
    assert torch.equal(daux, w_daux)
    for a, b in zip(grads, w_grads):
        assert torch.equal(a, b)
    leaves = [p.float().requires_grad_() for p in planes]
    w_dxy, w_dzy = torch.autograd.grad(_gather_by_index(*leaves, rows),
                                       leaves, dq)
    assert dxy.dtype == dzy.dtype == torch.float32
    torch.testing.assert_close(dxy, w_dxy, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(dzy, w_dzy, atol=1e-5, rtol=1e-5)


def test_stage1_step_takes_the_quad_op_and_matches_jax():
    """``models.use_pallas_mlp_quad`` reaches the port's renderer through
    build_renderer (it used not to), and a stage-1 loss with perturb and
    sigma noise on JAX's draws goes through the quad op: loss (rtol 1e-4)
    and the raw gradient of every renderer parameter (per tensor 2e-4 of
    its largest entry, a thousandth of the entries 2e-3: a ReLU kink, see
    assert_grads_close) against havatar_tpu's stage-1 loss with the same
    key."""
    jc, tc = _cfgs(**{"models.use_pallas_mlp_quad": True})
    jb, tb = _batch()
    # havatar_tpu's stage-1 init_state, its renderer's init under jit (the
    # eager init costs most of a minute on the CPU)
    model = JS1.build_renderer(jc)
    B = jb["mv_rays"].shape[0]
    variables = jax.jit(functools.partial(
        model.init, num_coarse=4, num_fine=2, perturb=False))(
        jax.random.PRNGKey(0), jb["mv_rays"][..., :8], jb["mv_rays"][..., 8:11],
        jnp.zeros((B, jc.experiment.latent_code_dim)), jb["inv_head_T"],
        jb["front_render_cond"], jb["left_render_cond"],
        jb["right_render_cond"])
    codes = np.random.RandomState(5).randn(
        2, jc.experiment.latent_code_dim).astype(np.float32) * 0.3
    tstate = TS1.init_state(tc, 2, "cpu")
    tstate.renderer.load_state_dict(from_jax_params(variables), strict=True)
    with torch.no_grad():
        tstate.latent_codes.copy_(torch.from_numpy(codes))
    assert tstate.renderer.model_coarse.use_fused_quad
    assert TS1.build_renderer(_cfgs()[1]).model_coarse.use_fused_quad is False
    key = jax.random.PRNGKey(100)
    (jl, _), (gp, gl) = jax.jit(jax.value_and_grad(
        JS1.make_loss_fn(model, jc), has_aux=True))(
        (variables["params"], jnp.asarray(codes)), variables["buffers"], jb,
        key)
    nerf = tc.nerf.train
    n0 = Q.field_radiance_quad.launches
    calls = []
    real = Q._FieldRadianceQuad.apply

    def counting(*a):
        calls.append(a[4].shape[0])
        return real(*a)

    Q._FieldRadianceQuad.apply = counting
    try:
        tl, _ = TS1.make_loss_fn(tstate.renderer, tc)(
            tstate.latent_codes, tb, jax_draws(key, 2, 16, nerf.num_coarse,
                                               nerf.num_fine))
        tl.backward()
    finally:
        Q._FieldRadianceQuad.apply = real
    # one call a batch item and pass; the twins ran, nothing launched
    assert calls == [16 * nerf.num_coarse] * 2 + [16 * nerf.num_fine] * 2
    assert Q.field_radiance_quad.launches == n0
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-4)
    want = from_jax_params({"params": gp, "buffers": variables["buffers"]})
    want.pop("headpose_skin_net.canonical_Wvolume.init_lc")
    assert_grads_close({n: torch.zeros_like(p) if p.grad is None else p.grad
                        for n, p in tstate.renderer.named_parameters()},
                       want, kinks=True)
