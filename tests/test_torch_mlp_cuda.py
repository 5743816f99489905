"""The CUDA dense-chain kernels (csrc/mlp.cu) against their plain twins, on
the card.

This file imports no JAX, so it also runs on a GPU machine without it:

    python -m pytest --noconftest tests/test_torch_mlp_cuda.py -m cuda -q

Without a CUDA device every test here skips.

TF32 is off, so the twins' float32 products are full float32. Bounds:

* float32: kernel and twin differ by summation order, and the kernels' split
  TF32 products (three TF32 products for one float32 product) round within
  about 1.2x of a float32 product's error. Forward atol 2e-4, rtol 2e-3 (the
  JAX kernel's own bound); dx and the parameter gradients atol 1e-4 *
  max(1, |want|max), rtol 1e-4 (also JAX's). The backward recomputes the
  hidden layers on FFMA, each output summed in k order as the twin's, so
  their relu masks are the twin's.
* bfloat16: a hidden activation can round to the other bf16 neighbour, which
  moves an output by about 2^-8 of the activations' scale: forward atol 3e-2,
  rtol 3e-2; gradients are held by their relative L2 error, 2e-2, since one
  flipped mask or activation moves single entries of dx by a whole term.
"""

import numpy as np
import pytest
import torch

from havatar_tpu_torch.ops import mlp as M

FIN, HID, CF = M.FIN, M.HID, M.CF
NS = [524288, 131072, 32768, 100003, 1, 63]   # a step's coarse and fine calls


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the GPU machine)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _params(rng, dev):
    """The five layers at LeCun-normal scale (activations of order 1)."""
    shapes = [(HID, FIN), (HID, HID), (CF, HID), (1, HID), (3, CF)]
    out = []
    for o, i in shapes:
        out.append(torch.from_numpy(
            rng.randn(o, i).astype(np.float32) / np.sqrt(i)).to(dev))
        out.append(torch.from_numpy(
            rng.randn(o).astype(np.float32) * 0.2).to(dev))
    return tuple(out)


def _inputs(rng, dev, N, dtype):
    x = torch.from_numpy(rng.randn(N, FIN).astype(np.float32)).to(dev)
    g = torch.from_numpy(rng.randn(N, 3 + CF + 1).astype(np.float32)).to(dev)
    return x.to(dtype), g


def _rel_l2(got, want):
    return float((got.float() - want.float()).norm()
                 / want.float().norm().clamp_min(1e-12))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N", NS)
def test_forward_kernel_matches_twin(dev, N, dtype):
    rng = np.random.RandomState(N % 1000)
    dt = getattr(torch, dtype)
    params = _params(rng, dev)
    x, _ = _inputs(rng, dev, N, dt)
    n0 = M.mlp_forward.launches
    got = M.mlp_forward(x, *params)
    torch.cuda.synchronize()
    assert M.mlp_forward.launches == n0 + 1
    want = M.fused_mlp_chain_plain(x, *params)
    assert got.shape == want.shape == (N, 68) and got.dtype == torch.float32
    tol = (dict(atol=2e-4, rtol=2e-3) if dtype == "float32"
           else dict(atol=3e-2, rtol=3e-2))
    torch.testing.assert_close(got, want, **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N", NS)
def test_backward_kernel_matches_twin(dev, N, dtype):
    rng = np.random.RandomState(N % 1000 + 1)
    dt = getattr(torch, dtype)
    params = _params(rng, dev)
    x, g = _inputs(rng, dev, N, dt)
    n0 = M.mlp_backward.launches
    dx, grads = M.mlp_backward(x, g, *params)
    torch.cuda.synchronize()
    assert M.mlp_backward.launches == n0 + 1
    want_dx, want = M.fused_mlp_chain_bwd_plain(x, g, *params)
    assert dx.dtype == dt and dx.shape == x.shape
    names = ("dx", "w0", "b0", "w1", "b1", "w_feat", "b_feat", "w_alpha",
             "b_alpha", "w_rgb", "b_rgb")
    for name, a, b in zip(names, (dx, *grads), (want_dx, *want)):
        assert a.shape == b.shape, name
        if dtype == "float32":
            scale = max(1.0, float(b.abs().max()))
            torch.testing.assert_close(a, b, atol=1e-4 * scale, rtol=1e-4,
                                       msg=lambda m: f"{name}: {m}")
        else:
            assert _rel_l2(a, b) < 2e-2, (name, _rel_l2(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_launches_bit_identical(dev, dtype):
    """No atomics: two backward launches on the same inputs give the same dx
    and parameter gradients bit for bit (a stage-1 step's coarse call)."""
    rng = np.random.RandomState(11)
    params = _params(rng, dev)
    x, g = _inputs(rng, dev, 524288, getattr(torch, dtype))
    dx_a, a = M.mlp_backward(x, g, *params)
    dx_b, b = M.mlp_backward(x, g, *params)
    torch.cuda.synchronize()
    assert torch.equal(dx_a, dx_b)
    for p, q in zip(a, b):
        assert torch.equal(p, q)


@pytest.mark.cuda
def test_autograd_function_on_the_card(dev):
    """fused_mlp_chain on CUDA tensors: gradients reach x and all ten
    parameters through the two kernels and agree with autograd of the
    twin; a second differentiation raises."""
    rng = np.random.RandomState(7)
    params = tuple(p.requires_grad_() for p in _params(rng, dev))
    x, g = _inputs(rng, dev, 5000, torch.float32)
    x.requires_grad_()
    n0 = M.fused_mlp_chain.launches
    out = M.fused_mlp_chain(x, *params)
    got = torch.autograd.grad(out, (x, *params), g)
    assert M.fused_mlp_chain.launches == n0 + 2
    want = torch.autograd.grad(M.fused_mlp_chain_plain(x, *params),
                               (x, *params), g)
    for a, b in zip(got, want):
        scale = max(1.0, float(b.abs().max()))
        torch.testing.assert_close(a, b, atol=1e-4 * scale, rtol=1e-4)
    out = M.fused_mlp_chain(x, *params)
    (dx,) = torch.autograd.grad(out.sum(), x, create_graph=True)
    with pytest.raises(RuntimeError):
        dx.sum().backward()


@pytest.mark.cuda
def test_wrong_widths_raise_on_the_card(dev):
    rng = np.random.RandomState(8)
    params = list(_params(rng, dev))
    x = torch.randn(8, FIN + 16, device=dev)
    params[0] = torch.randn(HID, FIN + 16, device=dev)
    with pytest.raises(ValueError, match="built for"):
        M.mlp_forward(x, *params)
    with pytest.raises(TypeError):
        M.mlp_forward(torch.randn(8, FIN, device=dev).half(),
                      *_params(rng, dev))
