"""The CUDA quad field kernels (the ``mlp_quad_*`` entry points of
csrc/mlp.cu) against their plain twins, on the card.

This file imports no JAX, so it also runs on a GPU machine without it:

    python -m pytest --noconftest tests/test_torch_quad_cuda.py -m cuda -q

Without a CUDA device every test here skips.

TF32 is off, so the twins' float32 products are full float32. Bounds, as for
the dense chain (tests/test_torch_mlp_cuda.py):

* float32: kernel and twin differ by summation order only (the corner
  reduction's too). Forward atol 2e-4, rtol 2e-3; dq, daux and the
  parameter gradients atol 1e-4 * max(1, |want|max), rtol 1e-4, with one
  row of dq and daux in 10,000 allowed a ReLU mask on the other side of
  its kink (``check_f32_grad``).
* bfloat16: a reduced input or a hidden activation can round to the other
  bf16 neighbour: forward atol 3e-2, rtol 3e-2; gradients by their relative
  L2 error, 2e-2.
"""

import numpy as np
import pytest
import torch

from havatar_tpu_torch.ops import mlp as M
from havatar_tpu_torch.ops import mlp_quad as Q

C, N_PE = Q.C_PLANE, Q.N_PE
NS = [262144, 100003, 32768, 63, 1]
GRAD_NAMES = ("dq", "daux", "w0", "b0", "w1", "b1", "w_feat", "b_feat",
              "w_alpha", "b_alpha", "w_rgb", "b_rgb")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the GPU machine)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _params(rng, dev):
    """The five layers at LeCun-normal scale (activations of order 1)."""
    shapes = [(M.HID, M.FIN), (M.HID, M.HID), (M.CF, M.HID), (1, M.HID),
              (3, M.CF)]
    out = []
    for o, i in shapes:
        out.append(torch.from_numpy(
            rng.randn(o, i).astype(np.float32) / np.sqrt(i)).to(dev))
        out.append(torch.from_numpy(
            rng.randn(o).astype(np.float32) * 0.2).to(dev))
    return tuple(out)


def _inputs(rng, dev, N, dtype):
    """Quad rows, aux (posenc ++ bilinear-like corner weights, each plane's
    four summing to 1) and a cotangent."""
    q = torch.from_numpy(rng.randn(N, 8 * C).astype(np.float32)).to(dev)
    w = rng.rand(N, 2, 4).astype(np.float32)
    w = (w / w.sum(-1, keepdims=True)).reshape(N, 8)
    pe = rng.uniform(-1, 1, (N, N_PE)).astype(np.float32)
    aux = torch.from_numpy(np.concatenate([pe, w], 1)).to(dev)
    g = torch.from_numpy(rng.randn(N, 3 + M.CF + 1).astype(np.float32)).to(dev)
    return q.to(dtype), aux, g


def check_f32_grad(name, got, want, rows=None):
    """A float32 gradient of the kernel against the twin's: atol 1e-4 *
    max(1, |want|max), rtol 1e-4. A gradient with a row a point (``rows``:
    of N points) may have one row in 10,000 (at least one) off: a point
    whose reduced input puts a hidden unit within rounding of the ReLU's
    kink can take its other side (kernel and twin sum the corners in
    another order), which moves that point's dx by a whole term. For a
    plane's gradient a row is a texel, and such a point moves up to 4 of
    them."""
    tol = dict(atol=1e-4 * max(1.0, float(want.abs().max())), rtol=1e-4)
    if rows is None:
        torch.testing.assert_close(got, want, **tol,
                                   msg=lambda m: f"{name}: {m}")
        return
    flips = max(1, rows // 10000)
    allowed = flips * (4 if got.shape[0] != rows else 1)
    bad = int((~torch.isclose(got, want, **tol)).reshape(
        got.shape[0] if got.shape[0] == rows else -1,
        got.shape[-1]).any(1).sum())
    assert bad <= allowed, (name, bad, allowed)


def _rel_l2(got, want):
    return float((got.float() - want.float()).norm()
                 / want.float().norm().clamp_min(1e-12))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N", NS)
def test_forward_kernel_matches_twin(dev, N, dtype):
    rng = np.random.RandomState(N % 1000 + 2)
    params = _params(rng, dev)
    q, aux, _ = _inputs(rng, dev, N, getattr(torch, dtype))
    n0 = Q.quad_forward.launches
    got = Q.quad_forward(q, aux, *params)
    torch.cuda.synchronize()
    assert Q.quad_forward.launches == n0 + 1
    want = Q.field_radiance_quad_plain(q, aux, *params)
    assert got.shape == want.shape == (N, 68) and got.dtype == torch.float32
    tol = (dict(atol=2e-4, rtol=2e-3) if dtype == "float32"
           else dict(atol=3e-2, rtol=3e-2))
    torch.testing.assert_close(got, want, **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N", NS)
def test_backward_kernel_matches_twin(dev, N, dtype):
    rng = np.random.RandomState(N % 1000 + 3)
    params = _params(rng, dev)
    q, aux, g = _inputs(rng, dev, N, getattr(torch, dtype))
    n0 = Q.quad_backward.launches
    dq, daux, grads = Q.quad_backward(q, aux, g, *params)
    torch.cuda.synchronize()
    assert Q.quad_backward.launches == n0 + 1
    w_dq, w_daux, want = Q.field_radiance_quad_bwd_plain(q, aux, g, *params)
    assert dq.dtype == daux.dtype == torch.float32
    for name, a, b in zip(GRAD_NAMES, (dq, daux, *grads),
                          (w_dq, w_daux, *want)):
        assert a.shape == b.shape, name
        if dtype == "float32":
            check_f32_grad(name, a, b, N if name in ("dq", "daux") else None)
        else:
            assert _rel_l2(a, b) < 2e-2, (name, _rel_l2(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_op_on_the_card(dev, dtype):
    """field_radiance_quad on CUDA planes: one forward and one backward
    launch, gradients to the planes, points, posenc and all ten parameters
    against autograd of the twin on the same gathered rows (float32:
    ``check_f32_grad``; bf16: relative L2 2e-2); a second differentiation
    raises."""
    rng = np.random.RandomState(9)
    dt = getattr(torch, dtype)
    params = tuple(p.requires_grad_() for p in _params(rng, dev))
    H = W = 33
    planes = [torch.from_numpy(rng.randn(H, W, C).astype(np.float32))
              .to(dev).to(dt).requires_grad_() for _ in range(2)]
    N = 20000
    warped = torch.from_numpy(rng.uniform(-1.1, 1.1, (N, 3))
                              .astype(np.float32)).to(dev).requires_grad_()
    pe = torch.from_numpy(rng.uniform(-1, 1, (N, N_PE)).astype(np.float32)
                          ).to(dev).requires_grad_()
    g = torch.from_numpy(rng.randn(N, 68).astype(np.float32)).to(dev)
    inputs = (*planes, warped, pe, *params)
    n0 = Q.field_radiance_quad.launches
    out = Q.field_radiance_quad(*planes, warped, pe, *params)
    got = torch.autograd.grad(out, inputs, g)
    assert Q.field_radiance_quad.launches == n0 + 2

    def plain(pxy, pzy, w, p, *prm):
        quads, _, w8 = Q.gather_quads(pxy, pzy, w)
        return Q.field_radiance_quad_plain(quads, torch.cat([p, w8], -1),
                                           *prm)

    want = torch.autograd.grad(plain(*inputs), inputs, g)
    for i, (a, b) in enumerate(zip(got, want)):
        if dtype == "float32":
            check_f32_grad(f"input {i}", a, b, N if i < 4 else None)
        else:
            assert _rel_l2(a, b) < 2e-2, (i, _rel_l2(a, b))
    out = Q.field_radiance_quad(*planes, warped, pe, *params)
    (d,) = torch.autograd.grad(out.sum(), planes[0], create_graph=True)
    with pytest.raises(RuntimeError):
        d.sum().backward()


@pytest.mark.cuda
def test_wrong_widths_raise_on_the_card(dev):
    rng = np.random.RandomState(8)
    params = _params(rng, dev)
    q, aux, _ = _inputs(rng, dev, 16, torch.float32)
    with pytest.raises(ValueError, match="built for"):
        Q.quad_forward(q[:, :8 * 32].contiguous(),
                       aux[:, 16:].contiguous(), *params)
    with pytest.raises(TypeError):
        Q.quad_forward(q.half(), aux, *params)
    with pytest.raises(TypeError):
        Q.quad_forward(q, aux.double(), *params)
