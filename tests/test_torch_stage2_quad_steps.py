"""The stage-2 steps of tests/test_torch_stage2_steps.py with
``models.use_pallas_mlp_quad`` on both sides: havatar_tpu's
``field_radiance_quad`` runs its Pallas kernels in interpret mode, the
port's runs its plain twins on the CPU. Same draws and bounds (every raw
gradient per tensor within 2e-4 of its largest entry); a file of its own to
keep each file's run short.
"""

import pytest

from test_torch_stage2_steps import check_step


@pytest.mark.parametrize("step", ["d_step", "g_step", "dg_step"])
def test_stage2_quad_step_gradients_match_jax(step):
    """d_step, g_step and dg_step through the fused quad op: the
    gradients reach the planes, the points and the five dense layers
    through the op's backward."""
    check_step(step, quad=True)
