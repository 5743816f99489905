"""The fused quad op (``ops/mlp_quad.py`` -> ``csrc/quad.cu``: gather of
the 8 corner texels, corner reduction and the dense chain, float32, one call
a batch item and pass). Forward: the two planes [H, W, C], the rows (2
int32) and aux (posenc ++ 8 corner weights, f32) of n samples and the
parameters in, the [n, out] radiance out. Backward: as much in plus the
cotangent, and the aux, plane and parameter gradients out (the algorithm
needs no recompute: activations could be kept). Operations: the chain's
products at the split-TF32 rate (the fastest float32-accurate route on the
tensor cores); the corner work (reduce; backward the splat and the corner
weights' gradients) in float32."""

from __future__ import annotations

from h100bench.peaks import least_s
from h100bench.roofline.field_mlp import Mlp

KERNELS = ("quad_fwd_kernel", "quad_fwd_mma_kernel", "quad_bwd_kernel",
           "sum_partials_kernel")


def call_least_s(mlp: Mlp, n: int, H: int, backward: bool) -> float:
    planes = 2 * H * H * mlp.C * 4
    rows_aux = n * (2 * 4 + (mlp.n_pe + 8) * 4)
    par = mlp.params() * 4
    out = n * mlp.out * 4
    corner = 2.0 * n * 8 * mlp.C
    if not backward:
        return least_s(planes + rows_aux + par + out, f32_ops=corner,
                       split_ops=2.0 * n * mlp.macs())
    nbytes = (planes + rows_aux + par + out + n * (mlp.n_pe + 8) * 4
              + planes + par)
    return least_s(nbytes, f32_ops=2 * corner,
                   split_ops=2.0 * n * 2 * mlp.macs())
