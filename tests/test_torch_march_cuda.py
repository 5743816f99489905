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

``kind`` picks the kernel pair: "quad" is march_coarse / march_fine (the
planes and each sample's cells in: the kernels gather the corner texels),
"x" is march_coarse_x / march_fine_x (reduced MLP input in). The march has
no atomics, so two launches give the same outputs bit for bit.
"""

import numpy as np
import pytest
import torch
import torch.nn as nn

from havatar_tpu_torch.ops import march as M
from havatar_tpu_torch.ops.mlp_quad import quad_rows

C, N_PE, CF, PLANE = 64, 48, 64, 128
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


def _planes(rng, dev, B=1, H=PLANE, W=PLANE):
    """Two seeded bf16 planes [B, H, W, C] (XY, ZY)."""
    return tuple(torch.from_numpy(rng.randn(B, H, W, C).astype(np.float32))
                 .bfloat16().to(dev) for _ in range(2))


def _cells(rng, dev, R, S, H=PLANE, W=PLANE, span=1.05):
    """rows [R, S, 2] and aux [R, S, N_PE + 8] of points over the sampling
    cube and up to ``span`` past it (the zero padding's work)."""
    warped = torch.from_numpy(
        ((rng.rand(R * S, 3) * 2 - 1) * span).astype(np.float32))
    rows, w8 = quad_rows(warped, H, W)
    pe = torch.from_numpy(np.sin(rng.randn(R, S, N_PE) * 3).astype(np.float32))
    aux = torch.cat([pe, w8.reshape(R, S, 8)], -1)
    return rows.reshape(R, S, 2).to(dev), aux.to(dev)


def _interleave(x_block):
    """[.., xy (C) | zy (C) | posenc] -> the reference's order (2c + p)."""
    planes = torch.stack([x_block[..., :C], x_block[..., C:2 * C]], -1)
    return torch.cat([planes.flatten(-2), x_block[..., 2 * C:]], -1)


def _reduced(planes, rows, aux):
    """The reduced MLP input of the same points, interleaved."""
    R, S, _ = rows.shape
    q = M.gather_quads(*planes, rows)
    x = M._build_x(q.reshape(R * S, -1), aux.reshape(R * S, -1), C, N_PE)
    return _interleave(x).reshape(R, S, -1).contiguous()


def _inputs(kind, rng, dev, R, S, planes=None, span=1.05):
    """The input-stage arguments of one kernel pair, as a tuple."""
    planes = planes if planes is not None else _planes(rng, dev)
    rows, aux = _cells(rng, dev, R, S, *planes[0].shape[1:3], span=span)
    if kind == "quad":
        return (*planes, rows, aux)
    return (_reduced(planes, rows, aux),)


KERNELS = {
    "quad": (M.march_coarse, M.march_coarse_gather_plain, M.march_fine,
             M.march_fine_gather_plain),
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
    planes = _planes(rng, dev)
    rows, a = _cells(rng, dev, R, S)
    x = _reduced(planes, rows, a)
    d = torch.from_numpy(rng.rand(R, S).astype(np.float32) * .2).to(dev)
    got_q = M.march_coarse(*planes, rows, a, d, mp_q)
    got_x = M.march_coarse_x(x, d, mp_x)
    _close_coarse(got_x, got_q, R, S)
    ranks = torch.from_numpy(np.stack(
        [rng.permutation(S // 2 + S) for _ in range(R)]).astype(np.int32))
    dc = torch.from_numpy(rng.rand(R, S // 2 + S).astype(np.float32) * .2)
    tail = (got_q[2], dc.to(dev), ranks.to(dev))
    for g, w in zip(M.march_fine_x(x, *tail, mp_x, S // 2),
                    M.march_fine(*planes, rows, a, *tail, mp_q, S // 2)):
        torch.testing.assert_close(g, w, **TOL)


def _both_passes(kind, rng, dev, mp, R, S, Sn, planes=None, span=1.05):
    """One coarse and one fine call of a pair, and the arguments of each."""
    coarse, _, fine, _ = KERNELS[kind]
    xs = _inputs(kind, rng, dev, R, S, planes, span)
    d = torch.from_numpy(rng.rand(R, S).astype(np.float32) * .2).to(dev)
    out = coarse(*xs, d, mp)
    Sk = S // 2
    ranks = torch.from_numpy(np.stack(
        [rng.permutation(Sk + Sn) for _ in range(R)]).astype(np.int32))
    dc = torch.from_numpy(rng.rand(R, Sk + Sn).astype(np.float32) * .2)
    fine_args = (*_inputs(kind, rng, dev, R, Sn, planes, span), out[2],
                 dc.to(dev), ranks.to(dev), mp, Sk)
    return (xs, d, mp), out, fine_args, fine(*fine_args)


@pytest.mark.cuda
def test_cuda_quad_kernels_take_each_items_planes(dev):
    """B = 2 items with different planes: each ray gathers from its own
    item's planes (rays r < R / 2 from item 0)."""
    R, S, Sn = 512, 16, 16
    rng = np.random.RandomState(6)
    mp = _params(rng, dev)[0]
    planes = _planes(rng, dev, B=2)
    args, got, fine_args, got_f = _both_passes("quad", rng, dev, mp, R, S, Sn,
                                               planes)
    torch.cuda.synchronize()
    _close_coarse(got, M.march_coarse_gather_plain(*args[0], *args[1:]), R, S)
    for g, w in zip(got_f, M.march_fine_gather_plain(*fine_args)):
        torch.testing.assert_close(g, w, **TOL)
    # item 1's rays against a twin that reads item 0's planes for them
    swapped = tuple(torch.cat([p[:1], p[:1]]) for p in planes)
    wrong = M.march_coarse_gather_plain(*swapped, *args[0][2:], *args[1:])
    assert not torch.allclose(got[0][R // 2:], wrong[0][R // 2:], **TOL)
    torch.testing.assert_close(got[0][:R // 2], wrong[0][:R // 2], **TOL)


@pytest.mark.cuda
def test_cuda_quad_kernels_on_points_outside_the_planes(dev):
    """Points up to 1.5x past the sampling cube: clamped cells whose
    outside corners weigh zero, as the twin's gather reads them."""
    R, S, Sn = 777, 16, 16
    rng = np.random.RandomState(7)
    mp = _params(rng, dev)[0]
    args, got, fine_args, got_f = _both_passes("quad", rng, dev, mp, R, S, Sn,
                                               span=1.5)
    torch.cuda.synchronize()
    assert bool((args[0][3][..., N_PE:] == 0).any())
    _close_coarse(got, M.march_coarse_gather_plain(*args[0], *args[1:]), R, S)
    for g, w in zip(got_f, M.march_fine_gather_plain(*fine_args)):
        torch.testing.assert_close(g, w, **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["quad", "x"])
@pytest.mark.parametrize("S", [16, 64])
def test_cuda_two_launches_are_bit_identical(dev, kind, S):
    """No atomics and a fixed order in every sum: two launches on the same
    inputs give the same rgbmap, weights and keeps bit for bit."""
    R = 1001
    rng = np.random.RandomState(8)
    mp = _params(rng, dev)[kind == "x"]
    coarse, _, fine, _ = KERNELS[kind]
    args, got, fine_args, got_f = _both_passes(kind, rng, dev, mp, R, S, 16)
    again, again_f = coarse(*args[0], *args[1:]), fine(*fine_args)
    torch.cuda.synchronize()
    for a, b in zip((*got, *got_f), (*again, *again_f)):
        assert torch.equal(a, b)


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
