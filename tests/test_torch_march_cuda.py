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


def _params(rng, dev):
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
    mp = M.march_params(lins[:2], lins[2], lins[3], lins[4], C, N_PE,
                        torch.bfloat16)
    return M.MarchParams(*(t.to(dev) for t in mp))


def _inputs(rng, dev, R, S):
    quads = torch.from_numpy(rng.randn(R, S, 8 * C).astype(np.float32))
    aux = np.concatenate([np.sin(rng.randn(R, S, N_PE) * 3),
                          rng.rand(R, S, 8) / 2], -1).astype(np.float32)
    return quads.bfloat16().to(dev), torch.from_numpy(aux).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("R,S,Sn", [(1024, 16, 16), (999, 64, 16),
                                    (257, 16, 4)])
def test_cuda_kernels_match_twins(dev, R, S, Sn):
    """Both kernels at the frame's widths (16 + 16), the golden schedule's
    64 coarse samples and a short fine pass, with ragged ray counts."""
    rng = np.random.RandomState(R + S + Sn)
    mp = _params(rng, dev)
    q, a = _inputs(rng, dev, R, S)
    d = torch.from_numpy(rng.rand(R, S).astype(np.float32) * .2).to(dev)
    n0 = M.march_coarse.launches
    got = M.march_coarse(q, a, d, mp)
    torch.cuda.synchronize()
    assert M.march_coarse.launches == n0 + 1
    want = M.march_coarse_plain(q, a, d, mp)
    for g, w in zip(got[:2], want[:2]):
        torch.testing.assert_close(g, w, **TOL)
    kg, kw = (k.float().view(R, S // 2, CF + 5) for k in (got[2], want[2]))
    torch.testing.assert_close(kg[..., :CF + 3], kw[..., :CF + 3], **KEEP_TOL)
    torch.testing.assert_close(kg[..., -2] + kg[..., -1],
                               kw[..., -2] + kw[..., -1], **KEEP_TOL)

    Sk = S // 2
    qn, an = _inputs(rng, dev, R, Sn)
    ranks = torch.from_numpy(np.stack(
        [rng.permutation(Sk + Sn) for _ in range(R)]).astype(np.int32))
    dc = torch.from_numpy(rng.rand(R, Sk + Sn).astype(np.float32) * .2)
    args = (qn, an, want[2], dc.to(dev), ranks.to(dev), mp, Sk)
    n0 = M.march_fine.launches
    got_f = M.march_fine(*args)
    torch.cuda.synchronize()
    assert M.march_fine.launches == n0 + 1
    for g, w in zip(got_f, M.march_fine_plain(*args)):
        torch.testing.assert_close(g, w, **TOL)


@pytest.mark.cuda
def test_cuda_wrappers_refuse_what_the_kernels_do_not_take(dev):
    """Wrong dtype, a non-contiguous tensor or a tensor on another device
    raise before any launch; nothing falls back to the twin."""
    rng = np.random.RandomState(0)
    mp = _params(rng, dev)
    q, a = _inputs(rng, dev, 64, 16)
    d = torch.rand(64, 16, device=dev)
    n0 = M.march_coarse.launches
    with pytest.raises(TypeError):
        M.march_coarse(q.float(), a, d, mp)
    with pytest.raises(ValueError):
        M.march_coarse(q, a, d.t().contiguous().t(), mp)
    with pytest.raises(ValueError):
        M.march_coarse(q, a, d.cpu(), mp)
    assert M.march_coarse.launches == n0
