"""The CUDA field kernels (csrc/mlp.cu's field_eval_f32 and field_eval_bf16)
against their plain twin, on the card.

This file imports no JAX, so it also runs on a GPU machine without it:

    python -m pytest --noconftest tests/test_torch_field_eval_cuda.py \
        -m cuda -q

Without a CUDA device every test here skips.

TF32 is off, so the twin's float32 products are full float32. The points
span [-5, 5], so posenc's top frequency (2^7) sees angles of a few hundred
radians; kernel and twin both take CUDA's sinf of the same float32 angles.
Bounds, as for the dense chain (tests/test_torch_mlp_cuda.py):

* float32: summation order only, atol 2e-4, rtol 2e-3 (the JAX kernel's own
  bound, tests/test_pallas_field.py);
* bfloat16 features: a hidden activation can round to its other bf16
  neighbour, which moves an output by about 2^-8 of the activations'
  scale: atol 3e-2, rtol 3e-2.
"""

import numpy as np
import pytest
import torch

from havatar_tpu_torch.ops import field as FE
from havatar_tpu_torch.ops import mlp as M

NS = [131072, 100003, 1310720, 1, 63]


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
    pts = torch.from_numpy(rng.uniform(-5, 5, (N, 3)).astype(np.float32))
    feat = torch.from_numpy(rng.randn(N, FE.FEAT_IN).astype(np.float32))
    return pts.to(dev), feat.to(dev).to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N", NS)
def test_kernel_matches_twin(dev, N, dtype):
    rng = np.random.RandomState(N % 1000 + 2)
    dt = getattr(torch, dtype)
    params = _params(rng, dev)
    pts, feat = _inputs(rng, dev, N, dt)
    n0 = FE.fused_field_eval.launches
    got = FE.fused_field_eval(pts, feat, *params)
    torch.cuda.synchronize()
    assert FE.fused_field_eval.launches == n0 + 1
    want = FE.fused_field_eval_plain(pts, feat, *params)
    assert got.shape == want.shape == (N, 68) and got.dtype == torch.float32
    tol = (dict(atol=2e-4, rtol=2e-3) if dtype == "float32"
           else dict(atol=3e-2, rtol=3e-2))
    torch.testing.assert_close(got, want, **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_posenc_equals_the_twins(dev, dtype):
    """Weights that carry each posenc column through the chain unchanged
    (hidden unit j = relu(enc_j), unit 64 + j = relu(-enc_j), layer1 the
    identity, feat_j = unit j - unit 64 + j; every product by 1, -1 or 0
    is exact) put the kernel's own posenc, in the chain's type, in feat's
    first 48 columns. It equals the twin's posenc bit for bit: both take
    CUDA's sinf of the same float32 angles."""
    from havatar_tpu_torch.ops.embedding import positional_encoding
    rng = np.random.RandomState(11)
    pe, n = M.FIN - FE.FEAT_IN, 70000
    z = torch.zeros
    w0, w1, wf = z(M.HID, M.FIN), torch.eye(M.HID), z(M.CF, M.HID)
    for j in range(pe):
        w0[j, FE.FEAT_IN + j], w0[64 + j, FE.FEAT_IN + j] = 1.0, -1.0
        wf[j, j], wf[j, 64 + j] = 1.0, -1.0
    params = tuple(t.to(dev) for t in (
        w0, z(M.HID), w1, z(M.HID), wf, z(M.CF), z(1, M.HID), z(1),
        z(3, M.CF), z(3)))
    pts, feat = _inputs(rng, dev, n, getattr(torch, dtype))
    got = FE.fused_field_eval(pts, feat, *params)[:, 3:3 + pe]
    want = positional_encoding(pts, FE.NUM_FREQS).to(feat.dtype).float()
    assert torch.equal(got, want), float((got - want).abs().max())


@pytest.mark.cuda
def test_wrong_inputs_raise_on_the_card(dev):
    rng = np.random.RandomState(8)
    params = _params(rng, dev)
    pts, feat = _inputs(rng, dev, 64, torch.float32)
    n0 = FE.fused_field_eval.launches
    with pytest.raises(ValueError, match="built for"):
        FE.fused_field_eval(pts, feat[:, :64].contiguous(), *params)
    with pytest.raises(ValueError, match="built for"):
        FE.fused_field_eval(pts, feat, *params, num_freqs=4)
    with pytest.raises(TypeError):
        FE.fused_field_eval(pts.double(), feat, *params)
    with pytest.raises(TypeError):
        FE.fused_field_eval(pts, feat.half(), *params)
    with pytest.raises(ValueError, match="contiguous"):
        FE.fused_field_eval(pts, feat.t().contiguous().t(), *params)
    with pytest.raises(ValueError, match="pts"):
        FE.fused_field_eval(pts[:63], feat, *params)
    wide = list(params)
    wide[0] = torch.randn(M.HID + 8, M.FIN, device=dev)
    with pytest.raises(ValueError):
        FE.fused_field_eval(pts, feat, *wide)
    assert FE.fused_field_eval.launches == n0
