"""The fused dense chain's plain twins and autograd function against
havatar_tpu's Pallas kernels (``ops/pallas_mlp.py``) in interpret mode, on
the CPU.

Inputs come from numpy seeds at the production widths (176 -> 128 -> 128 ->
65 -> 3) with an N that no tile divides. Tolerances are the JAX package's
own (tests/test_pallas_mlp.py), stated per test.
"""

import numpy as np
import pytest
import torch
import torch.nn as nn

import jax
import jax.numpy as jnp

from havatar_tpu.ops.pallas_mlp import fused_mlp_chain as jax_chain
from havatar_tpu_torch.ops import mlp as M

FIN, HID, CF = 176, 128, 64
NAMES = ("layer0", "layer1", "fc_rgbFeat", "fc_alpha", "fc_rgb")


def _jax_params(rng, fin=FIN, hid=HID, cf=CF, scale=0.05):
    def dense(i, o):
        return {"kernel": rng.randn(i, o).astype(np.float32) * scale,
                "bias": rng.randn(o).astype(np.float32) * scale}

    return {"layer0": dense(fin, hid), "layer1": dense(hid, hid),
            "fc_rgbFeat": dense(hid, cf), "fc_alpha": dense(hid, 1),
            "fc_rgb": dense(cf, 3)}


def _port_params(p, requires_grad=False):
    """The ten tensors in the op's order, as torch Linear holds them."""
    out = []
    for name in NAMES:
        out.append(torch.from_numpy(p[name]["kernel"].T.copy()))
        out.append(torch.from_numpy(p[name]["bias"].copy()))
    return tuple(t.requires_grad_(requires_grad) for t in out)


def _jax_grads_in_port_order(dp):
    out = []
    for name in NAMES:
        out.append(np.asarray(dp[name]["kernel"]).T)
        out.append(np.asarray(dp[name]["bias"]))
    return out


def test_forward_twin_matches_jax_kernel_f32():
    """fused_mlp_chain_plain vs the Pallas forward (interpret), float32,
    N = 3000 (not a multiple of the 2048-row tile): atol 2e-4, rtol 2e-3,
    the JAX test's bound (summation order only)."""
    rng = np.random.RandomState(0)
    p = _jax_params(rng)
    x = rng.randn(3000, FIN).astype(np.float32)
    want = np.asarray(jax_chain(jnp.asarray(x), p, interpret=True))
    got = M.fused_mlp_chain_plain(torch.from_numpy(x), *_port_params(p))
    assert got.shape == want.shape == (3000, 68)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=2e-3)


def test_forward_twin_matches_jax_kernel_bf16():
    """bf16 x: both sides round weights, hidden activations and feat to
    bf16 at the same points and accumulate in float32, in another order, so
    a hidden activation can land on the other bf16 neighbour: atol 2e-2,
    rtol 2e-2 against the kernel itself (the JAX package's own bf16 test
    allows 0.15 / 0.1 against its float32 reference)."""
    rng = np.random.RandomState(1)
    p = _jax_params(rng)
    x = rng.randn(2500, FIN).astype(np.float32)
    want = np.asarray(jax_chain(jnp.asarray(x, jnp.bfloat16), p,
                                interpret=True))
    got = M.fused_mlp_chain_plain(torch.from_numpy(x).bfloat16(),
                                  *_port_params(p))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), want, atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("via", ["bwd_twin", "autograd_function",
                                 "autograd_of_twin"])
def test_grads_match_jax_backward_kernel_f32(via):
    """dx and all ten parameter gradients (fc_rgbFeat and fc_alpha split)
    vs jax.grad through the Pallas backward (interpret, tile 512, N = 700):
    atol 1e-4 * max(1, |want|max), rtol 1e-4, the JAX test's bound. Three
    routes: the backward twin, the autograd.Function on CPU tensors (which
    runs that twin), and autograd of the forward twin."""
    rng = np.random.RandomState(3)
    p = _jax_params(rng)
    x = rng.randn(700, FIN).astype(np.float32)
    cot = rng.randn(700, 68).astype(np.float32)

    def loss(x, p):
        return jnp.sum(jax_chain(x, p, True, 512) * jnp.asarray(cot))

    want_dx, want_dp = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), p)
    want = [np.asarray(want_dx)] + _jax_grads_in_port_order(want_dp)

    g = torch.from_numpy(cot)
    if via == "bwd_twin":
        dx, grads = M.fused_mlp_chain_bwd_plain(torch.from_numpy(x), g,
                                                *_port_params(p))
        got = [dx, *grads]
    else:
        fn = (M.fused_mlp_chain if via == "autograd_function"
              else M.fused_mlp_chain_plain)
        xt = torch.from_numpy(x).requires_grad_()
        params = _port_params(p, requires_grad=True)
        got = torch.autograd.grad(fn(xt, *params), (xt, *params), g)
    assert len(got) == len(want) == 11
    for i, (a, b) in enumerate(zip(got, want)):
        assert tuple(a.shape) == b.shape, i
        scale = max(1.0, float(np.abs(b).max()))
        np.testing.assert_allclose(a.numpy(), b, atol=1e-4 * scale,
                                   rtol=1e-4, err_msg=f"gradient {i}")


def test_backward_twin_bf16_matches_jax_backward_kernel():
    """bf16 x through both backwards: dx comes back in bf16, the parameter
    gradients in float32. A cotangent or activation can land on the other
    bf16 neighbour on either side, so each gradient is held by its relative
    L2 error: 2e-2."""
    rng = np.random.RandomState(4)
    p = _jax_params(rng)
    x = rng.randn(600, FIN).astype(np.float32)
    cot = rng.randn(600, 68).astype(np.float32)

    def loss(x, p):
        return jnp.sum(jax_chain(x, p, True, 512) * jnp.asarray(cot))

    want_dx, want_dp = jax.grad(loss, argnums=(0, 1))(
        jnp.asarray(x, jnp.bfloat16), p)
    want = ([np.asarray(want_dx, np.float32)]
            + _jax_grads_in_port_order(want_dp))
    dx, grads = M.fused_mlp_chain_bwd_plain(
        torch.from_numpy(x).bfloat16(), torch.from_numpy(cot),
        *_port_params(p))
    assert dx.dtype == torch.bfloat16
    assert all(g.dtype == torch.float32 for g in grads)
    for i, (a, b) in enumerate(zip([dx, *grads], want)):
        err = np.linalg.norm(a.float().numpy() - b) / np.linalg.norm(b)
        assert err < 2e-2, (i, err)


def test_autograd_function_matches_linear_chain_and_fills_param_grads():
    """The op on CPU tensors against autograd of the plain nn.Linear chain
    at small widths (float32: the same products, so atol 1e-5, rtol 1e-5),
    with the Linear modules' own parameters as arguments: their .grad
    fills. A second differentiation raises."""
    torch.manual_seed(5)
    fin, hid, cf = 40, 32, 16
    lins = [nn.Linear(fin, hid), nn.Linear(hid, hid), nn.Linear(hid, cf),
            nn.Linear(hid, 1), nn.Linear(cf, 3)]
    x = torch.randn(101, fin, requires_grad=True)
    g = torch.randn(101, 3 + cf + 1)

    def chain(x):
        h = torch.relu(lins[1](torch.relu(lins[0](x))))
        feat = lins[2](h)
        return torch.cat([lins[4](feat), feat, lins[3](h)], -1)

    want_out = chain(x)
    want = torch.autograd.grad(want_out, [x] + [t for l in lins
                                                for t in l.parameters()], g)
    args = [t for l in lins for t in (l.weight, l.bias)]
    out = M.fused_mlp_chain(x, *args)
    torch.testing.assert_close(out, want_out, atol=1e-5, rtol=1e-5)
    (out * g).sum().backward()
    got = [x.grad] + [t.grad for l in lins for t in l.parameters()]
    for a, b in zip(got, want):
        assert a is not None
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)

    out = M.fused_mlp_chain(x, *args)
    (dx,) = torch.autograd.grad(out.sum(), x, create_graph=True)
    with pytest.raises(RuntimeError):
        dx.sum().backward()


def test_wrong_widths_raise():
    """Parameters that do not fit each other or x raise on any device; the
    CUDA kernels' own width check refuses everything but the production
    widths (176, 128, 64, 3) and float32 / bfloat16."""
    rng = np.random.RandomState(6)
    params = list(_port_params(_jax_params(rng, 40, 32, 16)))
    x = torch.randn(8, 40)
    M.fused_mlp_chain(x, *params)
    with pytest.raises(ValueError, match="expected"):
        M.fused_mlp_chain(torch.randn(8, 41), *params)
    bad = list(params)
    bad[2] = torch.randn(32, 31)
    with pytest.raises(ValueError, match="expected"):
        M.fused_mlp_chain_plain(x, *bad)
    with pytest.raises(ValueError, match="10 parameter"):
        M.fused_mlp_chain_plain(x, *params[:9])
    with pytest.raises(ValueError, match="built for"):
        M._check_cuda_widths(x, params)
    full = _port_params(_jax_params(rng))
    M._check_cuda_widths(torch.randn(8, FIN), full)
    with pytest.raises(TypeError, match="float32 or"):
        M._check_cuda_widths(torch.randn(8, FIN).half(), full)


def test_cpu_calls_launch_no_kernel():
    """The launch counters count kernel launches only: CPU calls leave them
    as they are."""
    before = (M.mlp_forward.launches, M.mlp_backward.launches,
              M.fused_mlp_chain.launches)
    rng = np.random.RandomState(7)
    params = _port_params(_jax_params(rng, 40, 32, 16), requires_grad=True)
    x = torch.randn(8, 40, requires_grad=True)
    M.fused_mlp_chain(x, *params).sum().backward()
    assert before == (M.mlp_forward.launches, M.mlp_backward.launches,
                      M.fused_mlp_chain.launches)


# ---------------------------------------------------------------------------
# the wrappers' host-side packing (plain PyTorch, what the CUDA kernels read)
# ---------------------------------------------------------------------------

def _weight(rng, k, n):
    """A weight with entries over many binades, ties included."""
    w = rng.randn(k, n).astype(np.float32) * 10.0 ** rng.uniform(-4, 3, (k, n))
    w[0, :4] = [1 + 2 ** -11, -(1 + 2 ** -11), (1 + 2 ** -11) * 2 ** -12, 0.0]
    return torch.from_numpy(w.astype(np.float32))


def test_tf32_split_keeps_ten_mantissa_bits_and_restores_the_weight():
    """hi has TF32's 10-bit mantissa (the low 13 bits are zero), rounded to
    nearest with ties away from zero as ``cvt.rna.tf32.f32`` rounds, and
    hi + lo is the weight bit for bit."""
    w = _weight(np.random.RandomState(20), 176, 128)
    hi, lo = M.tf32_split(w)
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    assert torch.equal(hi + lo, w)
    assert (lo.abs() <= hi.abs() * 2.0 ** -11).all()
    # nearest: no other TF32 value is closer to w than hi
    step = torch.ldexp(torch.ones_like(w), torch.frexp(hi)[1] - 11)
    assert ((w - hi).abs() <= step / 2).all()
    assert hi[0, :4].tolist() == [1 + 2 ** -10, -(1 + 2 ** -10),
                                  (1 + 2 ** -10) * 2 ** -12, 0.0]


@pytest.mark.parametrize("k, n, n_pad", [(176, 128, 0), (128, 176, 16),
                                         (64, 128, 0), (128, 64, 0)])
def test_tf32_fragments_unpack_to_the_weight(k, n, n_pad):
    """_tf32_frags [K/8, N/8, 32, 4] holds, for block (kb, nb) and lane
    4 g + t, (hi, hi, lo, lo) of w at (k = 8 kb + t, 8 kb + t + 4; n = 8 nb
    + g): read back element by element, hi + lo is the weight bit for bit
    and the padded columns are zero."""
    w = _weight(np.random.RandomState(k + n), k, n)
    f = M._tf32_frags(w, n_pad)
    assert f.shape == (k // 8, (n + n_pad) // 8, 32, 4)
    assert f.dtype == torch.float32 and f.is_contiguous()
    kb, nb, lane, e = np.meshgrid(np.arange(k // 8), np.arange((n + n_pad) // 8),
                                  np.arange(32), np.arange(4), indexing="ij")
    row = 8 * kb + lane % 4 + 4 * (e % 2)
    col = 8 * nb + lane // 4
    got = torch.zeros(2, k, n + n_pad)
    got[torch.from_numpy(e // 2), torch.from_numpy(row),
        torch.from_numpy(col)] = f
    hi, lo = M.tf32_split(w)
    assert torch.equal(got[0, :, :n], hi) and torch.equal(got[1, :, :n], lo)
    assert torch.equal(got[0, :, :n] + got[1, :, :n], w)
    assert not got[:, :, n:].any()


def test_bf16_fragments_unpack_to_the_weight():
    """_frags [K/8, N/8, 32] int32 holds, for block (kb, nb) and lane 4 g +
    t, bf16(w) at (k = 8 kb + 2t, 8 kb + 2t + 1; n = 8 nb + g), the first in
    the low half: read back, it is bf16(w) bit for bit."""
    w = _weight(np.random.RandomState(3), 128, 176)
    f = M._frags(w, 16)
    assert f.shape == (16, 24, 32) and f.dtype == torch.int32
    halves = f.view(torch.bfloat16).reshape(16, 24, 32, 2)
    kb, nb, lane, e = np.meshgrid(np.arange(16), np.arange(24), np.arange(32),
                                  np.arange(2), indexing="ij")
    got = torch.zeros(128, 192, dtype=torch.bfloat16)
    got[torch.from_numpy(8 * kb + 2 * (lane % 4) + e),
        torch.from_numpy(8 * nb + lane // 4)] = halves
    assert torch.equal(got[:, :176], w.to(torch.bfloat16))
    assert not got[:, 176:].float().any()


def test_unflatten_grads_reads_the_kernels_layout():
    """The backward kernels' flat gradient vector: dw0, dw1, dw_feat,
    dw_alpha, dw_rgb as [in, out], then the five biases, N_GRAD floats;
    unflatten_grads gives them back in the op's order and Linear's
    layouts."""
    rng = np.random.RandomState(21)
    grads = _port_params(_jax_params(rng))
    w0, b0, w1, b1, wf, bf, wa, ba, wr, br = grads
    flat = torch.cat([w0.t().reshape(-1), w1.t().reshape(-1),
                      wf.t().reshape(-1), wa.t().reshape(-1),
                      wr.t().reshape(-1), b0, b1, bf, ba, br])
    assert flat.numel() == M.N_GRAD == 47748
    for got, want in zip(M.unflatten_grads(flat), grads):
        assert torch.equal(got, want)


def test_backward_weights_in_kernel_order():
    """_bwd_args: bf16 gives the six products' bf16 fragments (w0 padded to
    W0_COLS), float32 the recompute's [in, out] copies and the transposed
    chain's split-TF32 fragments, then w_alpha, w_rgb, b0, b1, b_feat."""
    params = _port_params(_jax_params(np.random.RandomState(22)))
    f32 = M._bwd_args(params, False)
    assert [tuple(t.shape) for t in f32[:6]] == [
        (FIN, HID), (HID, HID), (HID, CF), (16, 24, 32, 4), (16, 16, 32, 4),
        (8, 16, 32, 4)]
    assert torch.equal(f32[3], M._tf32_frags(params[0], M.W0_COLS - FIN))
    b16 = M._bwd_args(params, True)
    assert [tuple(t.shape) for t in b16[:6]] == [
        (22, 16, 32), (16, 16, 32), (16, 8, 32), (16, 24, 32), (16, 16, 32),
        (8, 16, 32)]
    for a, b in zip(f32[6:], b16[6:]):
        assert torch.equal(a, b)
    assert torch.equal(f32[6], params[6]) and torch.equal(f32[10], params[5])
