"""The control: the reference in the program's place, computed in the
precision below the configuration's, comes out as not correct.

On the card (marker ``cuda``; run there with ``python -m pytest
h100bench/tests/test_bench_control.py -m cuda``) at each cell's own size on
one seed: TF32, the training cells' control, exists only on the card."""

from __future__ import annotations

import pytest
import torch

from h100bench import calibrate, harness


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control runs at the cell's "
                    "own size, and TF32 exists only on the card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["hd512.train_dg", "base512.train_s1"])
def test_control_fails_at_the_cells_size(cuda_device, name):
    cell = harness.find_cell(name)
    r = calibrate.readings(cell, 3000000017, "control", cuda_device)
    assert any(r[k] > cell.limits[k] for k in cell.limits)

