"""Split TF32 against FFMA for one float32 product, on the card.

The quad kernels' float32 products run on FFMA (csrc/quad.cu). Split TF32
(each operand v = hi + lo, hi = tf32(v), lo = tf32(v - hi); three TF32
``mma.sync`` products hi.hi + hi.lo + lo.hi) was tried for them and dropped
for its error. This file keeps that product alone, so that the error can be
re-read: ``tests/cuda/split_tf32.cu`` computes C [64][128] = A [64][176] .
B [176][128], the first layer's product at one tile, on four routes (FFMA;
one TF32 product; split TF32 in one accumulator; split TF32 with the small
terms in a second accumulator), and each is held against float64::

    python -m pytest --noconftest tests/test_torch_split_tf32_cuda.py \\
        -m cuda -q -s

It prints one JSON line: each route's largest error against float64, its
root-mean-square error, both in units of the largest |C|, how many of the
8192 outputs a seed have the other sign than float64's (a ReLU kink
crossed) and how many equal the FFMA route's bit for bit, over four seeds.
Without a CUDA device the test skips.

What it shows on an H100: split TF32 with the small terms in their own
accumulator is about as accurate as FFMA, in one accumulator a few times
less (each k step's small products are added into the large sum), one TF32
product far less; and no tensor-core route rounds as FFMA in k order does,
which is what the quad kernels' recomputed hidden layers need (their ReLU
masks must be the twin's).
"""

import ctypes
import json
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from havatar_tpu_torch.ops import cuda_build

SRC = Path(__file__).resolve().parent / "cuda" / "split_tf32.cu"
M, K, N = 64, 176, 128
ROUTES = ("ffma", "tf32", "split_tf32_one_acc", "split_tf32_two_acc")


@pytest.fixture(scope="module")
def lib():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the GPU machine)")
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = cuda_build.BUILD_DIR / "libsplit_tf32_test.so"
    subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o",
                    str(out), str(SRC)], check=True, capture_output=True)
    return ctypes.CDLL(str(out))


def _inputs(seed: int):
    """A like the chain's input rows (corner-reduced plane features of
    scale 0.5, posenc in [-1, 1]), B at LeCun-normal scale."""
    rng = np.random.RandomState(seed)
    a = np.concatenate([rng.randn(M, 128) * 0.5,
                        rng.uniform(-1, 1, (M, K - 128))], 1)
    b = rng.randn(K, N) / np.sqrt(K)
    return a.astype(np.float32), b.astype(np.float32)


@pytest.mark.cuda
def test_split_tf32_product_error(lib):
    res = {}
    for seed in range(4):
        ffma = None
        a, b = _inputs(seed)
        want = a.astype(np.float64) @ b.astype(np.float64)
        scale = float(np.abs(want).max())
        da = torch.from_numpy(a).cuda()
        db = torch.from_numpy(b).cuda()
        for route, name in enumerate(ROUTES):
            c = torch.empty(M, N, device="cuda")
            assert lib.split_tf32_product(
                ctypes.c_void_p(da.data_ptr()), ctypes.c_void_p(db.data_ptr()),
                ctypes.c_void_p(c.data_ptr()), route) == 0
            got = c.cpu().numpy().astype(np.float64)
            err = got - want
            ffma = got if ffma is None else ffma
            r = res.setdefault(name, {"max_err": 0.0, "rms_err": 0.0,
                                      "sign_flips": 0, "same_as_ffma": 0})
            r["same_as_ffma"] += int((got == ffma).sum())
            r["max_err"] = max(r["max_err"], float(np.abs(err).max()) / scale)
            r["rms_err"] = max(r["rms_err"],
                               float(np.sqrt((err ** 2).mean())) / scale)
            r["sign_flips"] += int((np.sign(got) != np.sign(want)).sum())
    print(json.dumps({"split_tf32_product": res}), flush=True)
    ffma = res["ffma"]["max_err"]
    one = res["split_tf32_one_acc"]["max_err"]
    two = res["split_tf32_two_acc"]["max_err"]
    assert res["ffma"]["max_err"] < 1e-6
    assert two < 2 * ffma            # split TF32, two accumulators
    assert one > two                 # the small terms in the large sum
    assert res["tf32"]["max_err"] > 100 * ffma
    assert all(res[k]["same_as_ffma"] < 4 * M * N for k in ROUTES[1:])
