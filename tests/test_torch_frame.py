"""The port's reenactment frame as a whole, against havatar_tpu and the
production golden render, plus the port's import and device rules.

Everything here runs on the CPU, where the march wrappers run their plain
twins. Tolerances are stated per case with their reason.
"""

import ast
import functools
import importlib.util
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from havatar_tpu.infer import reenact as JI
from havatar_tpu.models import generators as JG
from havatar_tpu.models import renderer as JR
from havatar_tpu.models import skinning as JS
from havatar_tpu_torch.checkpoints.convert import from_jax_params
from havatar_tpu_torch.device import resolve_device
from havatar_tpu_torch.infer import reenact as TI
from havatar_tpu_torch.models import generators as TG
from havatar_tpu_torch.models import renderer as TR
from havatar_tpu_torch.models import skinning as TS

import test_production_golden as golden

ROOT = Path(__file__).resolve().parents[1]


def _head_T(rng):
    a = rng.randn() * 0.2
    c, s = np.cos(a), np.sin(a)
    T = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c],
                  rng.randn(3) * 0.05], np.float32)
    return T[None]


def test_reenact_frame_matches_jax():
    """Port make_reenact_fn(gated=True) vs havatar_tpu's make_reenact_fn on
    the fused path (Pallas kernels in interpret mode), f32, tiny widths
    (tests/test_pallas_march.py's fused-renderer sizes), 16 coarse + 4 fine
    samples, a 4x super-resolution. Weights are the JAX modules' own
    initialisation carried across with from_jax_params.

    Tolerance atol 5e-5 on the [0, 1]-scale frame (measured 1e-5): both
    sides compute in f32, but the transmittance is a direct product here and
    exp(sum(log)) in the TPU kernel, and the difference moves the fine
    samples' depths by f32 rounding; the SR net then sums those renders over
    ~10^4 products.
    """
    rng = np.random.RandomState(0)
    kw = dict(plane_res=32, cond_res=32, plane_middle_size=8,
              skin_vol_res=16, render_size=8)
    sr_kw = dict(inp_size=8, inp_ch=64, out_ch=3, out_size=32, style_dim=16,
                 n_mlp=2, middle_size=4, channel_multiplier=1)
    B, R = 1, 64
    rays = TI.flagship_rays(8)
    bg = rng.rand(B, R, 3).astype(np.float32)
    latent = (rng.randn(B, 32) * 0.5).astype(np.float32)
    inv_T = _head_T(rng)
    conds = [rng.rand(B, 32, 32, 7).astype(np.float32) for _ in range(3)]
    style = rng.randn(1, 16).astype(np.float32)

    j_r = JR.AvatarRenderer(use_pallas_march=True, **kw)
    j_g = JG.StyleUNetSR(**sr_kw)
    key = jax.random.PRNGKey(0)
    # jitted inits: one compile is quicker on the CPU than op-by-op dispatch
    nerf_vars = jax.jit(functools.partial(
        j_r.init, num_coarse=4, num_fine=2, perturb=False))(
            key, jnp.asarray(rays[:, :8]), jnp.asarray(bg[:, :8]),
            jnp.asarray(latent), jnp.asarray(inv_T), *map(jnp.asarray, conds))
    g_params = jax.jit(j_g.init)(key, [jnp.asarray(style)],
                                 jnp.zeros((B, 8, 8, 64)))["params"]
    j_vol = JS.fix_canonical_volume(
        j_r.apply(nerf_vars, method=JR.AvatarRenderer.skin_volume))
    cfg = types.SimpleNamespace(nerf=types.SimpleNamespace(
        validation=types.SimpleNamespace(num_coarse=16, num_fine=4)))
    j_fn = JI.make_reenact_fn(cfg, j_r, j_g, to_uint8=False, gated=True)
    want = np.asarray(j_fn(nerf_vars, g_params, j_vol, jnp.asarray(style),
                           jnp.asarray(rays), jnp.asarray(bg),
                           jnp.asarray(latent), jnp.asarray(inv_T),
                           *map(jnp.asarray, conds)))

    t_r = TR.AvatarRenderer(use_fused_march=True, **kw)
    t_r.load_state_dict(from_jax_params(nerf_vars), strict=True)
    t_g = TG.StyleUNetSR(**sr_kw)
    t_g.load_state_dict(from_jax_params(g_params), strict=True)
    t_r.eval(), t_g.eval()
    with torch.no_grad():
        t_vol = TS.fix_canonical_volume(t_r.skin_volume())
    t_fn = TI.make_reenact_fn(t_r, t_g, num_coarse=16, num_fine=4,
                              gated=True, to_uint8=False)
    got = t_fn(t_vol, *(torch.from_numpy(a) for a in
                        (style, rays, bg, latent, inv_T, *conds)))
    assert got.shape == want.shape == (B, 32, 32, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=5e-5, rtol=0)


def _golden_render(g, idx, dtype):
    """The port's fused path (twins on the CPU) over golden rays ``idx``,
    blind 64+16, the golden planes given."""
    r = TR.AvatarRenderer(compute_dtype=dtype, use_fused_march=True)
    r.load_state_dict(from_jax_params({k: g[k] for k in g.files
                                       if k.startswith(("field.", "skin."))}),
                      strict=False)
    r.eval()
    t = lambda k: torch.from_numpy(np.asarray(g[k], np.float32))  # noqa: E731
    with torch.no_grad():
        vol = TS.fix_canonical_volume(r.skin_volume())
        out = r.render_rays(t("planes").to(dtype), t("rays")[:, idx],
                            t("bg")[:, idx], t("inv_head_T"),
                            num_coarse=int(g["num_coarse"]),
                            num_fine=int(g["num_fine"]), fixed_volume=vol)
    return out["rgb_fine"].float().numpy()


def _psnr(got, want):
    mse = np.mean((np.clip(got[..., :3], 0, 1)
                   - np.clip(want[..., :3], 0, 1)) ** 2)
    return float(10.0 * np.log10(1.0 / max(float(mse), 1e-20)))


def test_golden_subset_f32():
    """Every 32nd golden ray through the port's fused path in f32, held to
    the bound the JAX package holds its own render to
    (test_production_golden._check: >= 55 dB, atol 5e-3, rtol 1e-2)."""
    g = golden._load()
    want = g["render"].reshape(1, -1, g["render"].shape[-1])
    idx = np.arange(0, want.shape[1], 32)
    golden._check(_golden_render(g, idx, torch.float32), want[:, idx])


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_golden_subset_bf16_against_jax_fused_path():
    """The port's bf16 fused path (what the CUDA kernels compute) on the
    golden subset is no more than 1 dB below havatar_tpu's fused path at the
    same precision (bf16, Pallas in interpret mode). This also measures the
    JAX figure that chip_smoke.py holds its full-frame golden render to."""
    g = golden._load()
    want = g["render"].reshape(1, -1, g["render"].shape[-1])
    idx = np.arange(0, want.shape[1], 32)
    renderer, variables, vol = golden._build(g)
    j = JR.AvatarRenderer(use_pallas_march=True, compute_dtype="bfloat16")
    # jitted: one compile is quicker on the CPU than op-by-op dispatch
    render = jax.jit(functools.partial(
        j.apply, num_coarse=int(g["num_coarse"]), num_fine=int(g["num_fine"]),
        perturb=False, method=JR.AvatarRenderer.render_rays))
    out = render(variables, jnp.asarray(g["planes"], jnp.bfloat16),
                 jnp.asarray(g["rays"])[:, idx], jnp.asarray(g["bg"])[:, idx],
                 jnp.asarray(g["inv_head_T"]), fixed_volume=vol)
    jax_db = _psnr(np.asarray(out["rgb_fine"], np.float32), want[:, idx])
    port_db = _psnr(_golden_render(g, idx, torch.bfloat16), want[:, idx])
    assert port_db >= jax_db - 1.0, (port_db, jax_db)
    assert abs(_chip_smoke().JAX_GOLDEN_BF16_PSNR_DB - jax_db) < 0.05, jax_db


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax_flax_or_havatar_tpu():
    """The port and its GPU smoke script import no jax, flax or havatar_tpu
    module. ``havatar_tpu_torch`` shares the ``havatar_tpu`` prefix, so the
    match is on the exact name or the ``havatar_tpu.`` prefix."""
    files = sorted((ROOT / "havatar_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    bad = []
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "flax") or top == "havatar_tpu":
                bad.append(f"{f.relative_to(ROOT)}: {mod}")
    assert not bad, bad


def test_entry_points_raise_without_cuda(monkeypatch):
    """No device and no CUDA: the entry points raise; device='cpu' is the
    only way onto the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TI.build_flagship()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TI.mean_style(8)
    assert resolve_device("cpu") == torch.device("cpu")
    assert TI.mean_style(8, n=4, device="cpu").device.type == "cpu"


def test_tiny_flagship_frame_on_cpu():
    """build_flagship's frame at tiny widths, bf16 as on the GPU: the
    frame has the SR size, is finite, and the 128^2-render stand-in's rgb
    (sigmoid colours over a white background) lies in [0, 1]."""
    fs = TI.build_flagship(device="cpu", render_size=16, cond_res=32,
                           plane_res=32, plane_middle_size=8, sr_out=32)
    img = fs.frame_fn(**fs.inputs)
    assert img.shape == (1, 32, 32, 3) and torch.isfinite(img).all()
    with torch.no_grad():
        render, _ = fs.renderer.render_full_image(
            fs.inputs["rays"], fs.inputs["bg"], fs.inputs["latent"],
            fs.inputs["inv_head_T"], fs.inputs["front"], fs.inputs["left"],
            fs.inputs["right"], num_coarse=16, num_fine=16,
            fixed_volume=fs.inputs["fixed_volume"])
    rgb = render[..., :3].float()
    assert rgb.min() >= 0.0 and rgb.max() <= 1.0 + 1e-6
