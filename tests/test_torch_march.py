"""The march kernels' plain twins vs the JAX Pallas kernels (interpret
mode), at the sizes of tests/test_pallas_march.py's quad test. The CUDA
kernels are held to the twins in tests/test_torch_march_cuda.py.

Tolerances are test_pallas_march.py's for the quad kernels: 1e-5 (rtol
2e-5) for rgbmap and weights, 5e-3 (rtol 1e-2) for the bf16 keeps, where an
f32 association difference in the MLP can flip one bf16 rounding.
"""

import numpy as np
import pytest
import torch
import torch.nn as nn

import jax
import jax.numpy as jnp

from havatar_tpu.ops.pallas_march import (
    fused_march_coarse_quad,
    fused_march_fine_quad,
)
from havatar_tpu_torch.ops import march as M

R, S, C, N_PE = 64, 8, 64, 48
FIN = 2 * C + N_PE


def _jax_params(rng):
    def dense(i, o):
        return {"kernel": rng.randn(i, o).astype(np.float32) * .2,
                "bias": rng.randn(o).astype(np.float32) * .2}

    return {"layer0": dense(FIN, 128), "layer1": dense(128, 128),
            "fc_alpha": dense(128, 1), "fc_rgbFeat": dense(128, 64),
            "fc_rgb": dense(64, 3)}


def _linear(d):
    lin = nn.Linear(*d["kernel"].shape)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(d["kernel"].T.copy()))
        lin.bias.copy_(torch.from_numpy(d["bias"]))
    return lin


def _march_params(p, dtype=torch.float32):
    return M.march_params([_linear(p["layer0"]), _linear(p["layer1"])],
                          _linear(p["fc_rgbFeat"]), _linear(p["fc_alpha"]),
                          _linear(p["fc_rgb"]), C, N_PE, dtype)


def _quad_inputs(rng, Sx):
    quads = rng.randn(R, Sx, 8 * C).astype(np.float32)
    aux = np.concatenate([rng.randn(R, Sx, N_PE), rng.rand(R, Sx, 8)],
                         -1).astype(np.float32)
    return quads, aux


def _close(got, want, tol, name):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=2 * tol, err_msg=name)


def _jax(p):
    return jax.tree_util.tree_map(jnp.asarray, p)


def test_coarse_twin_matches_jax_kernel():
    rng = np.random.RandomState(7)
    p = _jax_params(rng)
    quads, aux = _quad_inputs(rng, S)
    dists = rng.rand(R, S).astype(np.float32)
    want = fused_march_coarse_quad(jnp.asarray(quads), jnp.asarray(aux),
                                   jnp.asarray(dists), _jax(p),
                                   interpret=True)
    got = M.march_coarse_plain(torch.from_numpy(quads),
                               torch.from_numpy(aux),
                               torch.from_numpy(dists), _march_params(p))
    for g, w, name, tol in zip(got, want, ("rgbmap", "weights", "keeps"),
                               (1e-5, 1e-5, 5e-3)):
        _close(g, w, tol, name)


def test_fine_twin_matches_jax_kernel():
    rng = np.random.RandomState(8)
    p = _jax_params(rng)
    Sn, Sk = 4, S // 2
    Sa = Sn + Sk
    quads, aux = _quad_inputs(rng, S)
    _, _, keeps = fused_march_coarse_quad(
        jnp.asarray(quads), jnp.asarray(aux),
        jnp.asarray(rng.rand(R, S).astype(np.float32)), _jax(p),
        interpret=True)
    qn, auxn = _quad_inputs(rng, Sn)
    ranks = np.stack([rng.permutation(Sa) for _ in range(R)]).astype(np.int32)
    d_concat = rng.rand(R, Sa).astype(np.float32)
    want = fused_march_fine_quad(jnp.asarray(qn), jnp.asarray(auxn), keeps,
                                 jnp.asarray(d_concat), jnp.asarray(ranks),
                                 _jax(p), num_keep=Sk, interpret=True)
    keeps_t = torch.from_numpy(np.asarray(keeps, np.float32)).bfloat16()
    got = M.march_fine_plain(torch.from_numpy(qn), torch.from_numpy(auxn),
                             keeps_t, torch.from_numpy(d_concat),
                             torch.from_numpy(ranks), _march_params(p), Sk)
    # the twin multiplies the transmittance directly; the TPU kernel takes
    # exp(sum(log)): a rounding difference inside the 1e-5 bound
    for g, w, name in zip(got, want, ("rgbmap", "weights")):
        _close(g, w, 1e-5, name)


def test_wrappers_run_the_twin_on_cpu_tensors():
    rng = np.random.RandomState(9)
    mp = _march_params(_jax_params(rng))
    quads, aux = (torch.from_numpy(a) for a in _quad_inputs(rng, S))
    dists = torch.from_numpy(rng.rand(R, S).astype(np.float32))
    before = M.march_coarse.launches
    got = M.march_coarse(quads, aux, dists, mp)
    want = M.march_coarse_plain(quads, aux, dists, mp)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert M.march_coarse.launches == before   # no kernel ran


@pytest.mark.parametrize("S_,C_,n_pe,hidden", [
    (12, 64, 48, 128), (16, 63, 48, 128), (16, 64, 40, 128),
    (16, 64, 48, 96)])
def test_kernel_width_checks(S_, C_, n_pe, hidden):
    """Widths the CUDA kernels are not built for raise before any launch."""
    mp = M.MarchParams(torch.empty(hidden, 2 * C_ + n_pe), None, None, None,
                       None, None, torch.empty(3, 64), None)
    with pytest.raises(ValueError):
        M._check_widths(S_, C_, n_pe, mp)
