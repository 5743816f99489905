"""The operations and bytes of each kernel family, and the operation count
of the whole step, against hand counts at small shapes."""

from __future__ import annotations

import pytest
import torch
import torch.nn.functional as F

from h100bench import flops, peaks
from h100bench.roofline import chain, quad
from h100bench.roofline.field_mlp import Mlp

MLP = Mlp(C=2, n_pe=2, hid=4, cf=3)     # fin 6, out 7


def test_mlp_counts():
    assert MLP.fin == 6 and MLP.out == 7
    # 6*4 + 4*4 + 4*(3+1) + 3*3 multiply-adds a row
    assert MLP.macs() == 24 + 16 + 16 + 9
    assert MLP.params() == 65 + 4 + 4 + 4 + 3


def test_least_s_takes_the_larger():
    assert peaks.least_s(3.35e12) == pytest.approx(1.0)
    assert peaks.least_s(0, bf16_ops=989e12, f32_ops=67e12) == \
        pytest.approx(2.0)
    assert peaks.least_s(0, split_ops=495e12) == pytest.approx(3.0)


@pytest.mark.parametrize("backward", [False, True])
def test_quad_and_chain_calls(backward):
    n, H = 10, 2
    planes = 2 * H * H * 2 * 4
    rows_aux = n * (8 + 10 * 4)
    par = 80 * 4
    out = n * 7 * 4
    if backward:
        q_bytes = planes + rows_aux + par + out + n * 10 * 4 + planes + par
        q_t = max(q_bytes / peaks.HBM_BYTES_S,
                  2 * 2 * n * 8 * 2 / peaks.F32_OPS_S
                  + 2 * n * 2 * 65 / peaks.SPLIT_TF32_OPS_S)
        c_bytes = n * 6 * 4 + out + par + n * 6 * 4 + par
        c_t = max(c_bytes / peaks.HBM_BYTES_S,
                  2 * n * 2 * 65 / peaks.SPLIT_TF32_OPS_S)
    else:
        q_t = max((planes + rows_aux + par + out) / peaks.HBM_BYTES_S,
                  2 * n * 8 * 2 / peaks.F32_OPS_S
                  + 2 * n * 65 / peaks.SPLIT_TF32_OPS_S)
        c_t = max((n * 6 * 4 + par + out) / peaks.HBM_BYTES_S,
                  2 * n * 65 / peaks.SPLIT_TF32_OPS_S)
    assert quad.call_least_s(MLP, n, H, backward) == pytest.approx(q_t)
    assert chain.call_least_s(MLP, n, backward) == pytest.approx(c_t)


def test_operation_counter_counts_a_convolution_and_its_backward():
    x = torch.zeros(2, 3, 8, 8, device="meta", requires_grad=True)
    w = torch.zeros(5, 3, 3, 3, device="meta", requires_grad=True)
    fwd = 2 * 2 * 5 * 8 * 8 * 3 * 3 * 3
    assert flops._count(lambda: F.conv2d(x, w, padding=1)) == fwd
    assert flops._count(
        lambda: F.conv2d(x, w, padding=1).sum().backward()) == 3 * fwd
