"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit) and the least time of a piece of
work at them. A share of a peak is stated with the card's name and power
limit beside it (``run.py`` prints both)."""

from __future__ import annotations

HBM_BYTES_S = 3.35e12
BF16_OPS_S = 989e12          # tensor cores, dense
TF32_OPS_S = 495e12          # tensor cores, dense
F32_OPS_S = 67e12            # outside the tensor cores (FFMA)
# a float32 product as three TF32 products (hi*hi + hi*lo + lo*hi): the
# fastest route that keeps float32's accuracy on the tensor cores
SPLIT_TF32_OPS_S = TF32_OPS_S / 3
# the peak of the precision a traffic file's ``precision`` names
# (float32: TF32 off, as the published float32 math wants)
PEAK_OPS_S = {"bf16": BF16_OPS_S, "float32": F32_OPS_S}


def least_s(nbytes: float, bf16_ops: float = 0.0, f32_ops: float = 0.0,
            split_ops: float = 0.0) -> float:
    """The larger of the bytes' time at the HBM rate and the operations'
    time at their peak rates."""
    t_ops = (bf16_ops / BF16_OPS_S + f32_ops / F32_OPS_S
             + split_ops / SPLIT_TF32_OPS_S)
    return max(nbytes / HBM_BYTES_S, t_ops)
