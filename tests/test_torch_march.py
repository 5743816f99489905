"""The march kernels' plain twins vs the JAX Pallas kernels (interpret
mode), at the sizes of tests/test_pallas_march.py's quad test. The CUDA
kernels are held to the twins in tests/test_torch_march_cuda.py.

The twins on JAX's own contract (``march_coarse_plain``,
``march_fine_plain``: corner rows in) take the JAX kernels' inputs; the
twins on the CUDA kernels' contract (``march_coarse_gather_plain``,
``march_fine_gather_plain``: the planes, each sample's cells and aux) take
seeded planes and cells, and the JAX kernels the corner rows that numpy
gathers from the same planes by the same cells.

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
from havatar_tpu_torch.ops.grid_sample import grid_sample_2d_quad
from havatar_tpu_torch.ops.mlp_quad import gather_rows, quad_rows

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


# planes of two batch items, a few texels a side
B, PH, PW = 2, 9, 11


def _cell_inputs(rng, Sx, span=1.05):
    """Planes [B, PH, PW, C], cells rows [R, Sx, 2] (points over the cube
    and up to ``span`` past it: the zero padding's work), aux
    [R, Sx, N_PE + 8], and numpy's corner rows quads [R, Sx, 8C] gathered
    from item r // (R // B)'s planes by the same cells."""
    planes = rng.randn(2, B, PH, PW, C).astype(np.float32)
    warped = ((rng.rand(R * Sx, 3) * 2 - 1) * span).astype(np.float32)
    rows, w8 = quad_rows(torch.from_numpy(warped), PH, PW)
    rows = rows.numpy().reshape(R, Sx, 2)
    aux = np.concatenate([rng.randn(R, Sx, N_PE).astype(np.float32),
                          w8.numpy().reshape(R, Sx, 8)], -1)
    item = (np.arange(R) // (R // B))[:, None]
    quads = []
    for p in range(2):
        y0, x0 = rows[..., p] // (PW - 1), rows[..., p] % (PW - 1)
        for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1)):
            quads.append(planes[p][item, y0 + dy, x0 + dx])
    return planes, rows, aux, np.concatenate(quads, -1)


def _gather_args(planes, rows, aux):
    return (torch.from_numpy(planes[0]), torch.from_numpy(planes[1]),
            torch.from_numpy(rows), torch.from_numpy(aux))


def test_gather_twins_match_jax_kernels():
    """The twins on the CUDA kernels' contract against the JAX kernels fed
    numpy's corner rows of the same planes and cells, at B = 2."""
    rng = np.random.RandomState(10)
    p = _jax_params(rng)
    mp = _march_params(p)
    planes, rows, aux, quads = _cell_inputs(rng, S)
    dists = rng.rand(R, S).astype(np.float32)
    want = fused_march_coarse_quad(jnp.asarray(quads), jnp.asarray(aux),
                                   jnp.asarray(dists), _jax(p),
                                   interpret=True)
    got = M.march_coarse_gather_plain(*_gather_args(planes, rows, aux),
                                      torch.from_numpy(dists), mp)
    for g, w, name, tol in zip(got, want, ("rgbmap", "weights", "keeps"),
                               (1e-5, 1e-5, 5e-3)):
        _close(g, w, tol, name)

    Sn, Sk = 4, S // 2
    Sa = Sn + Sk
    planes_n, rows_n, aux_n, quads_n = _cell_inputs(rng, Sn)
    ranks = np.stack([rng.permutation(Sa) for _ in range(R)]).astype(np.int32)
    d_concat = rng.rand(R, Sa).astype(np.float32)
    keeps = torch.from_numpy(np.asarray(want[2], np.float32)).bfloat16()
    want = fused_march_fine_quad(jnp.asarray(quads_n), jnp.asarray(aux_n),
                                 want[2], jnp.asarray(d_concat),
                                 jnp.asarray(ranks), _jax(p), num_keep=Sk,
                                 interpret=True)
    got = M.march_fine_gather_plain(
        *_gather_args(planes_n, rows_n, aux_n), keeps,
        torch.from_numpy(d_concat), torch.from_numpy(ranks), mp, Sk)
    for g, w, name in zip(got, want, ("rgbmap", "weights")):
        _close(g, w, 1e-5, name)


@pytest.mark.parametrize("where,span", [("inside", 1.0), ("edge", None),
                                        ("outside", 1.6)])
def test_cells_address_the_corner_rows_of_grid_sample_2d_quad(where, span):
    """quad_rows + gather_rows give each point the four texels and weights
    that grid_sample_2d_quad gives it (zeros padding), at B = 2: points
    inside the planes, on their last row and column and on the corners,
    and past them."""
    rng = np.random.RandomState(11)
    planes = torch.from_numpy(rng.randn(2, B, PH, PW, C).astype(np.float32))
    n = 500
    if span is None:
        edge = rng.choice([-1.0, 1.0], (B, n, 3)).astype(np.float32)
        free = (rng.rand(B, n, 3) * 2 - 1).astype(np.float32)
        keep = rng.rand(B, n, 3) < 0.5
        warped = torch.from_numpy(np.where(keep, edge, free))
    else:
        warped = torch.from_numpy(
            ((rng.rand(B, n, 3) * 2 - 1) * span).astype(np.float32))
    for b in range(B):
        rows, w8 = quad_rows(warped[b], PH, PW)
        got = gather_rows(planes[0, b], planes[1, b], rows)
        want_xy, w_xy = grid_sample_2d_quad(planes[0, b:b + 1],
                                            warped[b:b + 1, :, [0, 1]])
        want_zy, w_zy = grid_sample_2d_quad(planes[1, b:b + 1],
                                            warped[b:b + 1, :, [2, 1]])
        assert torch.equal(got, torch.cat([want_xy, want_zy], -1)[0])
        assert torch.equal(w8, torch.cat([w_xy, w_zy], -1)[0])
        if where == "outside":
            assert bool((w8 == 0).any())   # some corners padded with zeros


def test_gather_quads_takes_each_rays_item():
    """Rays r < R // B read item 0's planes, the rest item 1's."""
    rng = np.random.RandomState(12)
    planes, rows, aux, quads = _cell_inputs(rng, S)
    got = M.gather_quads(torch.from_numpy(planes[0]),
                         torch.from_numpy(planes[1]), torch.from_numpy(rows))
    assert torch.equal(got, torch.from_numpy(quads))


def test_wrappers_run_the_twin_on_cpu_tensors():
    rng = np.random.RandomState(9)
    mp = _march_params(_jax_params(rng))
    planes, rows, aux, _ = _cell_inputs(rng, S)
    args = _gather_args(planes, rows, aux)
    dists = torch.from_numpy(rng.rand(R, S).astype(np.float32))
    before = M.march_coarse.launches, M.march_fine.launches
    got = M.march_coarse(*args, dists, mp)
    want = M.march_coarse_gather_plain(*args, dists, mp)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    ranks = torch.arange(S // 2 + S, dtype=torch.int32).repeat(R, 1)
    dc = torch.rand(R, S // 2 + S)
    for g, w in zip(M.march_fine(*args, got[2], dc, ranks, mp, S // 2),
                    M.march_fine_gather_plain(*args, got[2], dc, ranks, mp,
                                              S // 2)):
        assert torch.equal(g, w)
    # no kernel ran
    assert (M.march_coarse.launches, M.march_fine.launches) == before


@pytest.mark.parametrize("S_,C_,n_pe,hidden", [
    (12, 64, 48, 128), (16, 63, 48, 128), (16, 64, 40, 128),
    (16, 64, 48, 96)])
def test_kernel_width_checks(S_, C_, n_pe, hidden):
    """Widths the CUDA kernels are not built for raise before any launch."""
    mp = M.MarchParams(torch.empty(hidden, 2 * C_ + n_pe), None, None, None,
                       None, None, torch.empty(3, 64), None)
    with pytest.raises(ValueError):
        M._check_widths(S_, C_, n_pe, mp)


def test_micro_march_runs_the_twins_on_the_cpu():
    """scripts/micro_march.py on the CPU: both schedules, every time it
    reports, the kernels being their twins."""
    from havatar_tpu_torch.scripts import micro_march

    res = micro_march.main(["--device", "cpu", "--n-rays", "32"])
    assert res["timer"] == "host clock"
    for name, (S, Sn) in micro_march.SCHEDULES.items():
        r = res[name]
        assert r["samples"] == [S, Sn]
        assert r["coarse_max_abs_err"] == 0 and r["fine_max_abs_err"] == 0
        for k in ("coarse_ms", "fine_ms", "posenc_ms", "cells_ms",
                  "field_inputs_quad_ms", "stage_coarse_ms",
                  "stage_fine_ms", "x_coarse_ms", "x_fine_ms"):
            assert r[k] > 0, k
