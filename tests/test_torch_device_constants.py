"""The ops' constants made on the device once (``utils/profiling.py:
device_constant``, ``device_numbers``): the Haar transforms, the box warps,
the plane lookups' and the quad op's column indices, the quad table's rows,
LPIPS and the compositing's cumulative product give, bit for bit, what the
formulas that copied host constants in every call gave (rebuilt here from
numpy, or with Python lists as indices, on seeded inputs, in float32 and
bfloat16), and a second call makes no new constant (``constant_uploads``).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from havatar_tpu_torch.ops import (boxwarp, grid_sample, mlp_quad, upfirdn2d,
                                   volume_render)
from havatar_tpu_torch.train import lpips as L
from havatar_tpu_torch.utils import profiling
from havatar_tpu_torch.utils.profiling import constant_uploads

DTYPES = [torch.float32, torch.bfloat16]
BOUNDS = ((-1.5, 1.5), (-1.6, 1.4), (-1.6, 1.2))


@pytest.fixture
def fresh(monkeypatch):
    """An empty constant cache for the test."""
    monkeypatch.setattr(profiling, "_CONSTANTS", {})


def _seeded(shape, dtype, seed=0):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return torch.from_numpy(x).to(dtype)


def _haar_np():
    """The four Haar kernels as the host formula built them."""
    lo = np.ones((1, 2), dtype=np.float32) / np.sqrt(2.0)
    hi = lo.copy()
    hi[0, 0] = -hi[0, 0]
    return [lo.T @ lo, hi.T @ lo, lo.T @ hi, hi.T @ hi]


def _weight(k: np.ndarray, x: torch.Tensor) -> torch.Tensor:
    """A kernel flipped, in x's dtype, expanded over x's channels."""
    w = torch.from_numpy(np.ascontiguousarray(k[::-1, ::-1])).to(x.dtype)
    return w.expand(x.shape[1], 1, *k.shape)


@pytest.mark.parametrize("dtype", DTYPES)
def test_haar_transforms_bitwise(dtype):
    x = _seeded((2, 3, 8, 8), dtype)
    want = torch.cat([F.conv2d(x, _weight(k, x), stride=2, groups=3)
                      for k in _haar_np()], 1)
    assert torch.equal(upfirdn2d.haar_transform(x), want)

    y = _seeded((2, 12, 4, 4), dtype, seed=1)
    ll, lh, hl, hh = _haar_np()
    want = 0
    for part, k in zip(y.chunk(4, dim=1), (ll, -lh, -hl, hh)):
        stuffed = part.new_zeros(2, 3, 8, 8)
        stuffed[:, :, ::2, ::2] = part
        want = want + F.conv2d(F.pad(stuffed, [1, 0, 1, 0]),
                               _weight(k, part), groups=3)
    assert torch.equal(upfirdn2d.inverse_haar_transform(y), want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("legacy", [False, True])
def test_box_warps_bitwise(dtype, legacy):
    scales, trans = boxwarp.get_box_warp_param(*BOUNDS)
    warp = (boxwarp.BoxWarpLegacy if legacy else boxwarp.BoxWarp)(
        scales, trans)
    s = torch.from_numpy(np.asarray(scales, np.float32))
    t = torch.from_numpy(np.asarray(trans, np.float32))
    c = _seeded((64, 3), dtype)
    if legacy:
        want, want_inv = 2.0 * (c * s + t), (c * 0.5 - t) / s
    else:
        want, want_inv = c * s + t, (c - t) / s
    assert torch.equal(warp(c), want)
    assert torch.equal(warp.inv(c), want_inv)


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_table_rows_bitwise(dtype):
    H, W = 9, 7
    rows_np = np.random.RandomState(2).randint(0, (H - 1) * (W - 1),
                                               (50, 2)).astype(dtype)
    rows = torch.from_numpy(rows_np.copy())
    got = mlp_quad._table_rows(rows, H, W)
    want = rows_np.astype(np.int64) + np.array([0, (H - 1) * (W - 1)])
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), want.reshape(-1))
    assert np.array_equal(rows.numpy(), rows_np)       # the input is kept


@pytest.mark.parametrize("dtype", DTYPES)
def test_lpips_bitwise(dtype):
    params = L._map_leaves(lambda t: t.to(dtype), L.init_lpips_params(
        torch.Generator().manual_seed(3)))
    a = _seeded((1, 16, 16, 3), dtype, seed=4).tanh()
    b = _seeded((1, 16, 16, 3), dtype, seed=5).tanh()
    shift = torch.from_numpy(np.array([-0.030, -0.088, -0.188])).to(dtype)
    scale = torch.from_numpy(np.array([0.458, 0.448, 0.450])).to(dtype)
    fa, fb = (L._vgg_features(params, ((x - shift) / scale)
                              .permute(0, 3, 1, 2)) for x in (a, b))
    want = 0.0
    for bi, (p, q) in enumerate(zip(fa, fb)):
        p = p * torch.rsqrt(p.square().sum(1, keepdim=True) + 1e-10)
        q = q * torch.rsqrt(q.square().sum(1, keepdim=True) + 1e-10)
        d = F.conv2d((p - q).square(), L._oihw(params["lin"][f"l{bi}"]))
        want = want + d.mean(dim=(1, 2, 3))
    assert torch.equal(L.lpips(params, a, b), want.mean())


@pytest.mark.parametrize("dtype", DTYPES)
def test_plane_lookups_bitwise(dtype):
    """The column indices that were Python lists: the triplane lookup's
    axes, the quad cells' (x, y), (z, y) pairs (with their gradient), the
    quad op's layer-0 order and its inverse."""
    coords = _seeded((2, 30, 3), torch.float32).tanh()
    planes = _seeded((2, 2, 5, 6, 4), dtype, seed=6)
    want = torch.stack([grid_sample.grid_sample_2d(planes[p],
                                                   coords[..., list(ax)])
                        for p, ax in enumerate(((0, 1), (2, 1)))], -1)
    assert torch.equal(grid_sample.sample_from_triplane(coords, planes), want)

    w_new = coords[0].clone().requires_grad_()
    w_old = coords[0].clone().requires_grad_()
    rows, w8 = mlp_quad.quad_rows(w_new, 5, 6)
    cells, w = mlp_quad._corners(w_old[:, [0, 1, 2, 1]].reshape(-1, 2), 5, 6,
                                 "zeros")
    assert torch.equal(rows, cells.reshape(-1, 2).int())
    assert torch.equal(w8, w.reshape(-1, 8).float())
    g = _seeded((30, 8), torch.float32, seed=7)
    w8.backward(g)
    w.reshape(-1, 8).float().backward(g)
    assert torch.equal(w_new.grad, w_old.grad)

    C, n_pe = 4, 6
    w0 = _seeded((5, 2 * C + n_pe), dtype, seed=8)
    perm, inv = mlp_quad._perm(C, n_pe)
    block = mlp_quad._block_order((w0,), C, n_pe)[0]
    assert torch.equal(block, w0[:, list(perm)])
    assert torch.equal(mlp_quad._cols(block, inv), w0)


def test_cumprod_exclusive_bitwise():
    """Forward and gradient as ``torch.cumprod``'s, on compositing's input
    (1 - alpha + 1e-10, no zero)."""
    alpha = torch.from_numpy(np.random.RandomState(9).rand(64, 80)
                             .astype(np.float32))
    alpha[:, 40:] = 1.0                      # opaque samples: x = 1e-10
    x_new = (1.0 - alpha + 1e-10).requires_grad_()
    x_old = x_new.detach().clone().requires_grad_()
    got = volume_render.cumprod_exclusive(x_new)
    cp = torch.cumprod(x_old, dim=-1)
    want = torch.cat([torch.ones_like(cp[..., :1]), cp[..., :-1]], dim=-1)
    assert torch.equal(got, want)
    g = _seeded((64, 80), torch.float32, seed=10)
    got.backward(g)
    want.backward(g)
    assert torch.equal(x_new.grad, x_old.grad)


def test_second_call_makes_no_constant(fresh):
    """Each op's constants are made on its first call for a (device,
    dtype), and never again."""
    x32, x16 = _seeded((1, 4, 4, 4), torch.float32), _seeded(
        (1, 4, 4, 4), torch.bfloat16)
    pts = _seeded((1, 8, 3), torch.float32).tanh()
    params = L.init_lpips_params(torch.Generator().manual_seed(3))
    img = _seeded((1, 16, 16, 3), torch.float32).tanh()
    planes = _seeded((2, 1, 4, 4, 4), torch.float32)
    made = []
    for call in (lambda: upfirdn2d.haar_transform(x32),
                 lambda: upfirdn2d.inverse_haar_transform(x32),
                 lambda: upfirdn2d.haar_transform(x16),
                 lambda: boxwarp.BoxWarp.from_bounds(BOUNDS)(pts),
                 lambda: boxwarp.BoxWarpLegacy.from_bounds(BOUNDS).inv(pts),
                 lambda: L.lpips(params, img, img),
                 lambda: grid_sample.sample_from_triplane(pts, planes),
                 lambda: mlp_quad.quad_rows(pts[0], 4, 4),
                 lambda: mlp_quad._block_order((x32[0, 0, :, :3],), 1, 1),
                 lambda: volume_render.cumprod_exclusive(x32),
                 lambda: mlp_quad._table_rows(
                     torch.zeros(3, 2, dtype=torch.int32), 4, 4)):
        call()
        n = constant_uploads()
        call()
        assert constant_uploads() == n
        made.append(n)
    # haar: LL, LH, HL, HH; the inverse adds -LH and -HL; bf16 its own
    # four; the box warp's scale and trans; LPIPS's shift and scale; the
    # triplane's two axis pairs; the quad cells' columns; the layer-0
    # order; the cumulative product and the rows none
    assert made == [4, 6, 10, 12, 12, 14, 16, 17, 18, 18, 18]


def test_key_holds_device_and_dtype(fresh):
    make = lambda: torch.ones(2)                      # noqa: E731
    cpu = profiling.device_constant("k", torch.device("cpu"), torch.float32,
                                    make)
    meta = profiling.device_constant("k", torch.device("meta"),
                                     torch.float32, make)
    bf16 = profiling.device_constant("k", torch.device("cpu"),
                                     torch.bfloat16, make)
    assert (cpu.device.type, meta.device.type, bf16.dtype) == (
        "cpu", "meta", torch.bfloat16)
    assert constant_uploads() == 3
    assert profiling.device_constant("k", torch.device("cpu"),
                                     torch.float32, make) is cpu


def test_constant_made_in_inference_mode_serves_training(fresh):
    """A constant first made under ``inference_mode`` (reenactment, serving)
    can be saved for a later training step's backward."""
    x = _seeded((1, 2, 4, 4), torch.float32)
    with torch.inference_mode():
        upfirdn2d.haar_transform(x)
    y = x.clone().requires_grad_()
    upfirdn2d.haar_transform(y).square().sum().backward()
    assert y.grad is not None and constant_uploads() == 4
