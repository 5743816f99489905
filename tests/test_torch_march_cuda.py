"""The CUDA march kernels against their plain twins, on the card.

This file imports no JAX, so it also runs on a GPU machine without it:

    python -m pytest --noconftest tests/test_torch_march_cuda.py -m cuda -q

(``--noconftest`` because tests/conftest.py sets JAX up). Without a CUDA
device every test here skips.

TF32 is off, so the twins' float32 matmuls are full float32. Kernel and twin
sum in different orders, which can flip the bf16 rounding of a hidden
activation: atol 1e-3, rtol 1e-2 on rgbmap and weights; the keeps are raw
MLP outputs in bf16, held to atol 5e-3, rtol 1e-2 (such a flip, or one bf16
ulp of the stored copy), the sigma (hi, lo) pair by its sum.

``kind`` picks the kernel pair: "quad" is march_coarse / march_fine (raw
corner rows in), "x" is march_coarse_x / march_fine_x (reduced MLP input in).
"""

import numpy as np
import pytest
import torch
import torch.nn as nn

from havatar_tpu_torch.ops import march as M

C, N_PE, CF = 64, 48, 64
TOL = dict(atol=1e-3, rtol=1e-2)
KEEP_TOL = dict(atol=5e-3, rtol=1e-2)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the GPU machine)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _params(rng, dev, permute=True):
    """The field's five layers at its LeCun-normal scale (activations of
    order 1, where the bf16 tolerances above are stated), random biases."""
    fin = 2 * C + N_PE
    lins = [nn.Linear(fin, 128), nn.Linear(128, 128), nn.Linear(128, CF),
            nn.Linear(128, 1), nn.Linear(CF, 3)]
    with torch.no_grad():
        for lin in lins:
            lin.weight.copy_(torch.from_numpy(
                rng.randn(*lin.weight.shape).astype(np.float32)
                / np.sqrt(lin.in_features)))
            lin.bias.copy_(torch.from_numpy(
                rng.randn(*lin.bias.shape).astype(np.float32) * 0.2))

    def mp(permute):
        return M.march_params(lins[:2], lins[2], lins[3], lins[4], C, N_PE,
                              torch.bfloat16, permute=permute).to(dev)

    return mp(True), mp(False)


def _quad_inputs(rng, dev, R, S):
    quads = torch.from_numpy(rng.randn(R, S, 8 * C).astype(np.float32))
    aux = np.concatenate([np.sin(rng.randn(R, S, N_PE) * 3),
                          rng.rand(R, S, 8) / 2], -1).astype(np.float32)
    return quads.bfloat16().to(dev), torch.from_numpy(aux).to(dev)


def _interleave(x_block):
    """[.., xy (C) | zy (C) | posenc] -> the reference's order (2c + p)."""
    planes = torch.stack([x_block[..., :C], x_block[..., C:2 * C]], -1)
    return torch.cat([planes.flatten(-2), x_block[..., 2 * C:]], -1)


def _inputs(kind, rng, dev, R, S):
    """The input-stage arguments of one kernel pair, as a tuple."""
    q, a = _quad_inputs(rng, dev, R, S)
    if kind == "quad":
        return q, a
    x = M._build_x(q.reshape(R * S, -1), a.reshape(R * S, -1), C, N_PE)
    return (_interleave(x).reshape(R, S, -1).contiguous(),)


KERNELS = {
    "quad": (M.march_coarse, M.march_coarse_plain, M.march_fine,
             M.march_fine_plain),
    "x": (M.march_coarse_x, M.march_coarse_x_plain, M.march_fine_x,
          M.march_fine_x_plain),
}


def _close_coarse(got, want, R, S):
    for g, w in zip(got[:2], want[:2]):
        torch.testing.assert_close(g, w, **TOL)
    kg, kw = (k.float().view(R, S // 2, CF + 5) for k in (got[2], want[2]))
    torch.testing.assert_close(kg[..., :CF + 3], kw[..., :CF + 3], **KEEP_TOL)
    torch.testing.assert_close(kg[..., -2] + kg[..., -1],
                               kw[..., -2] + kw[..., -1], **KEEP_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["quad", "x"])
@pytest.mark.parametrize("R,S,Sn", [(1024, 16, 16), (999, 64, 16),
                                    (257, 16, 4)])
def test_cuda_kernels_match_twins(dev, R, S, Sn, kind):
    """Both kernels of a pair at the frame's widths (16 + 16), the golden
    schedule's 64 coarse samples and a short fine pass, with ragged ray
    counts."""
    coarse, coarse_plain, fine, fine_plain = KERNELS[kind]
    rng = np.random.RandomState(R + S + Sn)
    mp = _params(rng, dev)[kind == "x"]
    xs = _inputs(kind, rng, dev, R, S)
    d = torch.from_numpy(rng.rand(R, S).astype(np.float32) * .2).to(dev)
    n0 = coarse.launches
    got = coarse(*xs, d, mp)
    torch.cuda.synchronize()
    assert coarse.launches == n0 + 1
    want = coarse_plain(*xs, d, mp)
    _close_coarse(got, want, R, S)

    Sk = S // 2
    xn = _inputs(kind, rng, dev, R, Sn)
    ranks = torch.from_numpy(np.stack(
        [rng.permutation(Sk + Sn) for _ in range(R)]).astype(np.int32))
    dc = torch.from_numpy(rng.rand(R, Sk + Sn).astype(np.float32) * .2)
    args = (*xn, want[2], dc.to(dev), ranks.to(dev), mp, Sk)
    n0 = fine.launches
    got_f = fine(*args)
    torch.cuda.synchronize()
    assert fine.launches == n0 + 1
    for g, w in zip(got_f, fine_plain(*args)):
        torch.testing.assert_close(g, w, **TOL)


@pytest.mark.cuda
def test_cuda_reduced_input_kernels_match_quad_kernels(dev):
    """On the same points the two pairs differ only in layer0's summation
    order (the reduced input is rounded where the quad kernel rounds it)."""
    R, S = 1000, 16
    rng = np.random.RandomState(5)
    mp_q, mp_x = _params(rng, dev)
    q, a = _quad_inputs(rng, dev, R, S)
    x = _interleave(M._build_x(q.reshape(R * S, -1), a.reshape(R * S, -1),
                               C, N_PE)).reshape(R, S, -1).contiguous()
    d = torch.from_numpy(rng.rand(R, S).astype(np.float32) * .2).to(dev)
    got_q = M.march_coarse(q, a, d, mp_q)
    got_x = M.march_coarse_x(x, d, mp_x)
    _close_coarse(got_x, got_q, R, S)
    ranks = torch.from_numpy(np.stack(
        [rng.permutation(S // 2 + S) for _ in range(R)]).astype(np.int32))
    dc = torch.from_numpy(rng.rand(R, S // 2 + S).astype(np.float32) * .2)
    tail = (got_q[2], dc.to(dev), ranks.to(dev))
    for g, w in zip(M.march_fine_x(x, *tail, mp_x, S // 2),
                    M.march_fine(q, a, *tail, mp_q, S // 2)):
        torch.testing.assert_close(g, w, **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["quad", "x"])
def test_cuda_wrappers_refuse_what_the_kernels_do_not_take(dev, kind):
    """Wrong dtype, a non-contiguous tensor, a tensor on another device or
    layer0 in the other pair's channel order raise before any launch;
    nothing falls back to the twin."""
    coarse, _, fine, _ = KERNELS[kind]
    rng = np.random.RandomState(0)
    mps = _params(rng, dev)
    mp, other = mps[kind == "x"], mps[kind != "x"]
    xs = _inputs(kind, rng, dev, 64, 16)
    d = torch.rand(64, 16, device=dev)
    n0 = coarse.launches, fine.launches
    with pytest.raises(TypeError):
        coarse(xs[0].float(), *xs[1:], d, mp)
    with pytest.raises(ValueError):
        coarse(*xs, d.t().contiguous().t(), mp)
    with pytest.raises(ValueError):
        coarse(*xs, d.cpu(), mp)
    with pytest.raises(ValueError, match="channel order"):
        coarse(*xs, d, other)
    keeps = torch.zeros(64 * 8, CF + 5, dtype=torch.bfloat16, device=dev)
    dc = torch.rand(64, 24, device=dev)
    ranks = torch.arange(24, dtype=torch.int32, device=dev).repeat(64, 1)
    with pytest.raises(TypeError):
        fine(*xs, keeps, dc, ranks.long(), mp, 8)
    with pytest.raises(ValueError, match="channel order"):
        fine(*xs, keeps, dc, ranks, other, 8)
    assert (coarse.launches, fine.launches) == n0
