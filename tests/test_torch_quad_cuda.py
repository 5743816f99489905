"""The CUDA quad field kernels (csrc/quad.cu: ``quad_forward_f32``,
``quad_forward_bf16``, ``quad_backward``) against their plain twins, on the
card, at the kernels' contract: the two planes [H, W, 64], each point's
cells ``rows`` [N, 2] int32 and aux = posenc ++ the corner weights.

This file imports no JAX, so it also runs on a GPU machine without it:

    python -m pytest --noconftest tests/test_torch_quad_cuda.py -m cuda -q

Without a CUDA device every test here skips.

TF32 is off, so the twins' float32 products are full float32. Bounds, as for
the dense chain (tests/test_torch_mlp_cuda.py):

* float32: kernel and twin differ by summation order only (the corner
  reduction is the twin's to the bit; the splat adds in another order).
  Forward atol 2e-4, rtol 2e-3; the plane gradients, daux and the parameter
  gradients atol 1e-4 * max(1, |want|max), rtol 1e-4, with one point in
  10,000 allowed a ReLU mask on the other side of its kink
  (``check_f32_grad``).
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
PLANE = 128                     # the production planes, 128^2 x 64
GRAD_NAMES = ("dplane_xy", "dplane_zy", "daux", "w0", "b0", "w1", "b1",
              "w_feat", "b_feat", "w_alpha", "b_alpha", "w_rgb", "b_rgb")


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


def _inputs(rng, dev, N, dtype, padding="zeros"):
    """Planes, the cells and corner weights of points spread over the box
    and a little past it (the padding's work), aux = posenc ++ those
    weights, and a cotangent."""
    planes = [torch.from_numpy(rng.randn(PLANE, PLANE, C).astype(np.float32))
              .to(dev).to(dtype) for _ in range(2)]
    warped = torch.from_numpy(rng.uniform(-1.05, 1.05, (N, 3))
                              .astype(np.float32)).to(dev)
    rows, w8 = Q.quad_rows(warped, PLANE, PLANE, padding)
    pe = rng.uniform(-1, 1, (N, N_PE)).astype(np.float32)
    aux = torch.cat([torch.from_numpy(pe).to(dev), w8], 1)
    g = torch.from_numpy(rng.randn(N, 3 + M.CF + 1).astype(np.float32)).to(dev)
    return planes, rows, aux, g


def check_f32_grad(name, got, want, rows=None):
    """A float32 gradient of the kernel against the twin's: atol 1e-4 *
    max(1, |want|max), rtol 1e-4. A gradient with a row a point (``rows``:
    of N points) may have one row in 10,000 (at least one) off: a point
    whose hidden unit sits within rounding of the ReLU's kink can take its
    other side (kernel and twin sum the products in another order), which
    moves that point's dx by a whole term. For a plane's gradient a row is
    a texel, and such a point moves up to 4 of them."""
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
@pytest.mark.parametrize("padding", ["zeros", "border"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N", NS)
def test_forward_kernel_matches_twin(dev, N, dtype, padding):
    rng = np.random.RandomState(N % 1000 + 2)
    params = _params(rng, dev)
    planes, rows, aux, _ = _inputs(rng, dev, N, getattr(torch, dtype),
                                   padding)
    n0 = Q.quad_forward.launches
    got = Q.quad_forward(*planes, rows, aux, *params)
    torch.cuda.synchronize()
    assert Q.quad_forward.launches == n0 + 1
    want = Q.field_radiance_quad_plain(*planes, rows, aux, *params)
    assert got.shape == want.shape == (N, 68) and got.dtype == torch.float32
    tol = (dict(atol=2e-4, rtol=2e-3) if dtype == "float32"
           else dict(atol=3e-2, rtol=3e-2))
    torch.testing.assert_close(got, want, **tol)


def _backward_vs_twin(got, want, N, dtype):
    for name, a, b in zip(GRAD_NAMES, (got[0], got[1], got[2], *got[3]),
                          (want[0], want[1], want[2], *want[3])):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        if dtype == "float32":
            check_f32_grad(name, a, b,
                           N if name.startswith("d") else None)
        else:
            assert _rel_l2(a, b) < 2e-2, (name, _rel_l2(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("padding", ["zeros", "border"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N", NS)
def test_backward_kernel_matches_twin(dev, N, dtype, padding):
    rng = np.random.RandomState(N % 1000 + 3)
    params = _params(rng, dev)
    planes, rows, aux, g = _inputs(rng, dev, N, getattr(torch, dtype),
                                   padding)
    n0 = Q.quad_backward.launches
    got = Q.quad_backward(*planes, rows, aux, g, *params)
    torch.cuda.synchronize()
    assert Q.quad_backward.launches == n0 + 1
    assert got[0].dtype == got[1].dtype == got[2].dtype == torch.float32
    _backward_vs_twin(
        got, Q.field_radiance_quad_bwd_plain(*planes, rows, aux, g, *params),
        N, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_weight_gradients_are_bit_identical(dev, dtype):
    """Two launches on the same inputs give the same weight and bias
    gradients, bit for bit: every block sums into its own partial and the
    partials are summed in block order (no atomics onto them)."""
    rng = np.random.RandomState(31)
    params = _params(rng, dev)
    planes, rows, aux, g = _inputs(rng, dev, 300007, getattr(torch, dtype))
    a = Q.quad_backward(*planes, rows, aux, g, *params)[3]
    b = Q.quad_backward(*planes, rows, aux, g, *params)[3]
    torch.cuda.synchronize()
    for i, (x, y) in enumerate(zip(a, b)):
        assert torch.equal(x, y), i


@pytest.mark.cuda
def test_no_corner_rows_are_allocated(dev):
    """At a G step's coarse call (N = 1,048,576) the op's forward and
    backward on the card stay under half the bytes of one [N, 8C] float32
    tensor (2 GiB) above what their inputs and outputs hold: the corner
    rows and their gradient never reach device memory."""
    rng = np.random.RandomState(32)
    params = tuple(p.requires_grad_() for p in _params(rng, dev))
    N = 1048576
    planes = [torch.from_numpy(rng.randn(PLANE, PLANE, C).astype(np.float32))
              .to(dev).requires_grad_() for _ in range(2)]
    warped = torch.from_numpy(rng.uniform(-1, 1, (N, 3)).astype(np.float32)
                              ).to(dev).requires_grad_()
    pe = torch.from_numpy(rng.uniform(-1, 1, (N, N_PE)).astype(np.float32)
                          ).to(dev).requires_grad_()
    g = torch.from_numpy(rng.randn(N, 68).astype(np.float32)).to(dev)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = Q.field_radiance_quad(*planes, warped, pe, *params)
    grads = torch.autograd.grad(out, (*planes, warped, pe, *params), g)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    assert len(grads) == 14
    assert extra < N * 8 * C * 4 // 2, extra


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
        rows, w8 = Q.quad_rows(w, *pxy.shape[:2])
        return Q.quad_chain_plain(Q.gather_rows(pxy, pzy, rows),
                                  torch.cat([p, w8], -1), *prm)

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
    planes, rows, aux, _ = _inputs(rng, dev, 16, torch.float32)
    with pytest.raises(ValueError, match="built for"):
        Q.quad_forward(*planes, rows, aux[:, 16:].contiguous(), *params)
    with pytest.raises(TypeError):
        Q.quad_forward(planes[0].half(), planes[1].half(), rows, aux, *params)
    with pytest.raises(TypeError):
        Q.quad_forward(*planes, rows, aux.double(), *params)
    with pytest.raises(TypeError):
        Q.quad_forward(*planes, rows.long(), aux, *params)
