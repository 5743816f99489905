"""The fused field op's plain twin (``ops/field.py``) against havatar_tpu's
Pallas kernel ``ops/pallas_field.py:fused_field_eval`` in interpret mode and
against the field itself, on the CPU; its micro entry point.

Inputs come from numpy seeds; JAX dense dicts cross through
``dense_params_from_jax``, a JAX field through ``from_jax_params``.
Tolerances are stated per test.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from havatar_tpu.models import nerf_field as JF
from havatar_tpu.ops.pallas_field import fused_field_eval as jax_field_eval
from havatar_tpu_torch.checkpoints.convert import (
    DENSE_LAYERS,
    dense_params_from_jax,
    from_jax_params,
)
from havatar_tpu_torch.models import nerf_field as TF
from havatar_tpu_torch.ops import field as FE
from havatar_tpu_torch.scripts import micro_field

F_IN, HID = 128, 128


def _jax_dense(rng, fin=F_IN + 48, hid=HID, cf=64, scale=0.05):
    """test_pallas_field.py's recipe: kernels and biases at scale 0.05."""
    def dense(i, o):
        return {"kernel": rng.randn(i, o).astype(np.float32) * scale,
                "bias": rng.randn(o).astype(np.float32) * scale}

    return {"layer0": dense(fin, hid), "layer1": dense(hid, hid),
            "fc_alpha": dense(hid, 1), "fc_rgbFeat": dense(hid, cf),
            "fc_rgb": dense(cf, 3)}


def test_dense_params_from_jax_layout():
    """The converter gives the ten tensors in dense_params() order, Linear
    layout ([out, in]), as float32 copies."""
    rng = np.random.RandomState(3)
    d = _jax_dense(rng)
    got = dense_params_from_jax(d)
    assert len(got) == 10
    for i, name in enumerate(DENSE_LAYERS):
        w, b = got[2 * i], got[2 * i + 1]
        assert w.dtype == b.dtype == torch.float32
        np.testing.assert_array_equal(w.numpy(), d[name]["kernel"].T)
        np.testing.assert_array_equal(b.numpy(), d[name]["bias"])
    assert [tuple(t.shape) for t in got[::2]] == [
        (HID, F_IN + 48), (HID, HID), (64, HID), (1, HID), (3, 64)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_twin_matches_jax_kernel(dtype):
    """fused_field_eval (the twin, on CPU tensors) vs the Pallas kernel in
    interpret mode at test_pallas_field.py's shape, N = 3000 (no 2048-row
    tile divides it). float32: atol 2e-4, rtol 2e-3, that test's bound
    (summation order, and sin to within an ulp or two on either side).
    bf16 features: both round posenc, the weights and the hidden
    activations to bf16 at the same points and accumulate in float32 in
    another order, so an activation can land on its other bf16 neighbour:
    atol 2e-2, rtol 2e-2 (tests/test_torch_mlp.py's bf16 bound)."""
    rng = np.random.RandomState(0)
    d = _jax_dense(rng)
    N = 3000
    pts = rng.randn(N, 3).astype(np.float32)
    feat = rng.randn(N, F_IN).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = np.asarray(jax_field_eval(jnp.asarray(pts),
                                     jnp.asarray(feat, jdt), d,
                                     interpret=True))
    tfeat = torch.from_numpy(feat).to(getattr(torch, dtype))
    params = dense_params_from_jax(d)
    n0 = FE.fused_field_eval.launches
    got = FE.fused_field_eval(torch.from_numpy(pts), tfeat, *params)
    assert FE.fused_field_eval.launches == n0      # CPU tensors: the twin
    assert got.shape == want.shape == (N, 68) and got.dtype == torch.float32
    tol = (dict(atol=2e-4, rtol=2e-3) if dtype == "float32"
           else dict(atol=2e-2, rtol=2e-2))
    np.testing.assert_allclose(got.numpy(), want, **tol)
    plain = FE.fused_field_eval_plain(torch.from_numpy(pts), tfeat, *params)
    torch.testing.assert_close(got, plain, rtol=0, atol=0)


def test_on_a_tiny_field_matches_the_field_and_jax():
    """tests/configs/tiny.yml's field (16 plane channels, 4 frequencies, so
    F_in = 32, posenc 24), a JAX DoublePlaneNeRFField's own initialisation
    carried across by from_jax_params: the op on the field's sampled plane
    features equals the port field's forward, JAX's field __call__ and
    JAX's Pallas kernel (interpret mode) on the same points and planes, in
    float32. atol 1e-5, rtol 1e-5 against the field (the same products;
    tests/test_torch_renderer.py's bound for the field); 2e-4 / 2e-3
    against the kernel (summation order)."""
    rng = np.random.RandomState(5)
    kw = dict(num_encoding_fn_xyz=4, latent_code_dim=20, plane_feat_dim=16,
              plane_res=32, cond_res=64, plane_middle_size=8)
    j = JF.DoublePlaneNeRFField(**kw)
    pts = (rng.rand(1, 500, 3) * 3.4 - 1.7).astype(np.float32)
    planes = (rng.randn(2, 1, 32, 32, 16) * 0.5).astype(np.float32)
    variables = jax.jit(j.init)(jax.random.PRNGKey(4), jnp.asarray(pts), None,
                                jnp.asarray(planes))
    want_jax = np.asarray(jax.jit(j.apply)(variables, jnp.asarray(pts), None,
                                           jnp.asarray(planes)))[0]
    jfeat = j.apply(variables, jnp.asarray(pts), jnp.asarray(planes),
                    method=JF.DoublePlaneNeRFField.sample_plane_features)
    want_kernel = np.asarray(jax_field_eval(
        jnp.asarray(pts[0]), jfeat[0], variables["params"], num_freqs=4,
        interpret=True))

    t = TF.DoublePlaneNeRFField(**kw)
    sd = from_jax_params({"params": {"field": variables["params"]}})
    missing, unexpected = t.load_state_dict(
        {k[len("model_coarse."):]: v for k, v in sd.items()}, strict=False)
    assert not unexpected and missing and all(
        k.startswith(("XY_gen.", "YZ_gen.")) for k in missing)
    for a, b in zip(t.dense_params(),
                    dense_params_from_jax(variables["params"])):
        torch.testing.assert_close(a.detach(), b, rtol=0, atol=0)
    tp, tpl = torch.from_numpy(pts), torch.from_numpy(planes)
    with torch.no_grad():
        feat = t.sample_plane_features(tp, tpl)[0]
        got = FE.fused_field_eval(tp[0], feat, *t.dense_params(),
                                  num_freqs=4)
        want = t(tp, None, tpl)[0]
    assert got.shape == (500, 3 + 64 + 1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), want_jax, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), want_kernel, atol=2e-4,
                               rtol=2e-3)


def test_micro_entry_point_on_the_cpu(capsys):
    """micro_field.main with --device cpu: the twin stands in for the
    kernel; the host clock times it; one JSON line with its keys."""
    n0 = FE.fused_field_eval.launches
    res = micro_field.main(["--device", "cpu", "--n", "4096"])
    assert FE.fused_field_eval.launches == n0
    assert set(res) == {"device", "n", "timer", "unfused_bf16_ms",
                        "fused_bf16_ms", "fused_calls"}
    assert (res["device"], res["n"], res["timer"]) == ("cpu", 4096,
                                                      "host clock")
    assert res["fused_calls"] == micro_field.WARMUP + micro_field.ITERS
    assert res["unfused_bf16_ms"] > 0 and res["fused_bf16_ms"] > 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("{") and '"fused_bf16_ms"' in line


def test_micro_inputs_and_the_unfused_path():
    """The micro script's inputs follow scripts/micro_pallas.py's recipe
    (the same numpy draws in the same order), and its unfused path is the
    JAX script's xla_path: bf16 products with bf16 biases. Against the
    fused twin, which adds float32 biases, bf16 allows atol 3e-2, rtol
    3e-2."""
    n = 1000
    pts, feat16, params = micro_field.make_inputs(n, torch.device("cpu"))
    rng = np.random.RandomState(0)
    d = _jax_dense(rng)
    np.testing.assert_array_equal(
        pts.numpy(), rng.randn(n, 3).astype(np.float32))
    # micro_pallas.py draws fc_alpha before fc_rgbFeat, as _jax_dense does
    for a, b in zip(params, dense_params_from_jax(d)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert feat16.dtype == torch.bfloat16 and feat16.shape == (n, F_IN)
    with torch.no_grad():
        unfused = micro_field.unfused_field_eval(pts, feat16, *params)
        fused = FE.fused_field_eval(pts, feat16, *params)
    assert unfused.dtype == torch.float32 and unfused.shape == (n, 68)
    np.testing.assert_allclose(unfused.numpy(), fused.numpy(), atol=3e-2,
                               rtol=3e-2)


def test_cpu_calls_check_shapes_and_launch_nothing():
    """On CPU tensors the op is the twin at any width (here F_in = 16, 2
    frequencies); mismatched rows raise."""
    rng = np.random.RandomState(9)
    d = _jax_dense(rng, fin=16 + 12, hid=32, cf=8)
    params = dense_params_from_jax(d)
    pts = torch.from_numpy(rng.randn(50, 3).astype(np.float32))
    feat = torch.from_numpy(rng.randn(50, 16).astype(np.float32))
    n0 = FE.fused_field_eval.launches
    out = FE.fused_field_eval(pts, feat, *params, num_freqs=2)
    assert out.shape == (50, 3 + 8 + 1)
    with pytest.raises(ValueError, match="pts"):
        FE.fused_field_eval(pts[:49], feat, *params, num_freqs=2)
    with pytest.raises(ValueError, match="parameter 0"):
        FE.fused_field_eval(pts, feat, *params, num_freqs=3)
    assert FE.fused_field_eval.launches == n0
