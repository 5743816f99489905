"""The fused dense chain (``ops/mlp.py`` -> ``csrc/mlp.cu``: the field's
five dense layers on n rows of plane features ++ posenc, float32).
Forward: x [n, fin] and the parameters in, [n, out] out. Backward: x, the
cotangent and the parameters in, dx and the parameter gradients out (no
recompute needed by the algorithm). Products at the split-TF32 rate."""

from __future__ import annotations

from h100bench.peaks import least_s
from h100bench.roofline.field_mlp import Mlp

KERNELS = ("mlp_fwd_kernel", "mlp_fwd_mma_kernel", "mlp_bwd_kernel",
           "sum_partials_kernel")


def call_least_s(mlp: Mlp, n: int, backward: bool) -> float:
    x = n * mlp.fin * 4
    par = mlp.params() * 4
    out = n * mlp.out * 4
    if not backward:
        return least_s(x + par + out, split_ops=2.0 * n * mlp.macs())
    return least_s(x + out + par + x + par,
                   split_ops=2.0 * n * 2 * mlp.macs())
