"""The port's renderer in its three inference configurations, the field, the
plane samplers and the reduced-input march twins, against havatar_tpu.

Everything runs on the CPU: the march wrappers run their plain twins and the
JAX Pallas kernels run in interpret mode. Inputs come from numpy seeds and
JAX weights cross over through ``from_jax_params``. Tolerances are stated
per case with their reason.
"""

import functools

import numpy as np
import pytest
import torch
import torch.nn as nn

import jax
import jax.numpy as jnp

from havatar_tpu.models import generators as JG
from havatar_tpu.models import nerf_field as JF
from havatar_tpu.models import renderer as JR
from havatar_tpu.models import skinning as JS
from havatar_tpu.ops import grid_sample as JGS
from havatar_tpu.ops.pallas_march import fused_march_coarse, fused_march_fine
from havatar_tpu_torch.checkpoints.convert import from_jax_params
from havatar_tpu_torch.checkpoints.stage2 import detect_nerf_enc_mode
from havatar_tpu_torch.models import generators as TG
from havatar_tpu_torch.models import nerf_field as TF
from havatar_tpu_torch.models import renderer as TR
from havatar_tpu_torch.models import skinning as TS
from havatar_tpu_torch.ops import grid_sample as TGS
from havatar_tpu_torch.ops import march as M
from havatar_tpu_torch.ops.mlp_quad import quad_rows

import test_golden_regression as tiny_golden
import test_production_golden as golden

C, N_PE = 64, 48
FIN = 2 * C + N_PE


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


# ---------------------------------------------------------------------------
# kernels 3 and 4: the reduced-input twins
# ---------------------------------------------------------------------------

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


def _march_params(p, dtype, permute):
    return M.march_params([_linear(p["layer0"]), _linear(p["layer1"])],
                          _linear(p["fc_rgbFeat"]), _linear(p["fc_alpha"]),
                          _linear(p["fc_rgb"]), C, N_PE, dtype,
                          permute=permute)


def _keeps_close(got, want, R, Sk, atol, rtol):
    """Packed keeps [R*Sk, 69]: feat and rgb as stored, sigma as hi + lo."""
    g = got.float().numpy().reshape(R, Sk, 69)
    w = np.asarray(want, np.float32).reshape(R, Sk, 69)
    np.testing.assert_allclose(g[..., :67], w[..., :67], atol=5e-3, rtol=1e-2)
    np.testing.assert_allclose(g[..., 67] + g[..., 68],
                               w[..., 67] + w[..., 68], atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reduced_input_twins_match_jax_kernels(dtype):
    """march_coarse_x_plain / march_fine_x_plain vs fused_march_coarse /
    fused_march_fine (interpret mode) on the same x.

    float32: rgbmap atol 1e-5 / rtol 1e-4, weights 1e-4 / 1e-3 (summation
    order; the twin multiplies the transmittance, the TPU kernel takes
    exp(sum(log))); the keeps' sigma as hi + lo to the same 1e-5, their bf16
    feat and rgb to 5e-3 / 1e-2 (one bf16 rounding can flip). bfloat16 x:
    both sides round weights and hidden activations to bf16 and accumulate
    in f32, but in another order, so a hidden activation can flip one bf16
    ulp: 2e-3 / 1e-2 on rgbmap and weights, 5e-3 / 1e-2 on sigma.
    """
    rng = np.random.RandomState(3)
    R, S, Sn = 64, 8, 4
    Sk, jdt = S // 2, jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    tol = (dict(atol=1e-5, rtol=1e-4) if dtype == "float32"
           else dict(atol=2e-3, rtol=1e-2))
    wtol = (dict(atol=1e-4, rtol=1e-3) if dtype == "float32" else tol)
    stol = ((1e-5, 1e-4) if dtype == "float32" else (5e-3, 1e-2))
    p = _jax_params(rng)
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    mp = _march_params(p, tdt, permute=False)
    x = rng.randn(R, S, FIN).astype(np.float32)
    dists = rng.rand(R, S).astype(np.float32)
    want = fused_march_coarse(jnp.asarray(x, jdt), jnp.asarray(dists), jp,
                              interpret=True)
    got = M.march_coarse_x_plain(_t(x).to(tdt), _t(dists), mp)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **tol)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), **wtol)
    _keeps_close(got[2], want[2], R, Sk, *stol)

    xn = rng.randn(R, Sn, FIN).astype(np.float32)
    ranks = np.stack([rng.permutation(Sk + Sn)
                      for _ in range(R)]).astype(np.int32)
    dcat = rng.rand(R, Sk + Sn).astype(np.float32)
    want_f = fused_march_fine(jnp.asarray(xn, jdt), want[2],
                              jnp.asarray(dcat), jnp.asarray(ranks), jp,
                              num_keep=Sk, interpret=True)
    keeps_t = _t(want[2]).bfloat16()
    got_f = M.march_fine_x_plain(_t(xn).to(tdt), keeps_t, _t(dcat),
                                 torch.from_numpy(ranks), mp, Sk)
    np.testing.assert_allclose(got_f[0].numpy(), np.asarray(want_f[0]), **tol)
    np.testing.assert_allclose(got_f[1].numpy(), np.asarray(want_f[1]),
                               **wtol)


def _interleave(x_block):
    planes = torch.stack([x_block[..., :C], x_block[..., C:2 * C]], -1)
    return torch.cat([planes.flatten(-2), x_block[..., 2 * C:]], -1)


def test_reduced_input_twins_match_quad_twins_on_the_same_points():
    """The quad twins reduce corner rows themselves; fed that same reduced
    input un-permuted, the reduced-input twins run the same MLP with
    layer0's columns in another order: float32 summation order only
    (atol 1e-5, rtol 1e-4)."""
    rng = np.random.RandomState(4)
    R, S, Sn = 32, 8, 4
    p = _jax_params(rng)
    mp_q = _march_params(p, torch.float32, permute=True)
    mp_x = _march_params(p, torch.float32, permute=False)
    assert (mp_q.order, mp_x.order) == ("block", "interleaved")

    def inputs(Sx):
        """The quad pair's input stage (two planes, cells, aux) and the
        reduced input of the same points."""
        planes = tuple(_t(rng.randn(1, 9, 9, C)) for _ in range(2))
        rows, w8 = quad_rows(_t(rng.rand(R * Sx, 3) * 2.1 - 1.05), 9, 9)
        a = torch.cat([_t(rng.randn(R, Sx, N_PE)), w8.reshape(R, Sx, 8)], -1)
        rows = rows.reshape(R, Sx, 2)
        q = M.gather_quads(*planes, rows)
        x = M._build_x(q.reshape(R * Sx, -1), a.reshape(R * Sx, -1), C, N_PE)
        return (*planes, rows, a), _interleave(x).reshape(R, Sx, FIN)

    q, x = inputs(S)
    d = _t(rng.rand(R, S))
    got_q = M.march_coarse(*q, d, mp_q)
    got_x = M.march_coarse_x(x, d, mp_x)
    for g, w in zip(got_x[:2], got_q[:2]):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-4)
    torch.testing.assert_close(got_x[2].float(), got_q[2].float(),
                               atol=5e-3, rtol=1e-2)
    qn, xn = inputs(Sn)
    ranks = torch.from_numpy(np.stack(
        [rng.permutation(S // 2 + Sn) for _ in range(R)]).astype(np.int32))
    tail = (got_q[2], _t(rng.rand(R, S // 2 + Sn)), ranks)
    for g, w in zip(M.march_fine_x(xn, *tail, mp_x, S // 2),
                    M.march_fine(*qn, *tail, mp_q, S // 2)):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("kind", ["quad", "x"])
def test_march_params_in_the_wrong_channel_order_raise(kind):
    """Each wrapper and twin takes layer0 in one channel order and raises
    on the other, so the wrong parameter set cannot pass silently."""
    rng = np.random.RandomState(5)
    p = _jax_params(rng)
    wrong = _march_params(p, torch.float32, permute=(kind == "x"))
    R, S = 4, 4
    d = torch.rand(R, S)
    keeps = torch.zeros(R * 2, 69, dtype=torch.bfloat16)
    tail = (keeps, torch.rand(R, 2 + S),
            torch.arange(2 + S, dtype=torch.int32).repeat(R, 1), wrong, 2)
    if kind == "quad":
        xs = (torch.randn(1, 4, 4, C), torch.randn(1, 4, 4, C),
              torch.zeros(R, S, 2, dtype=torch.int32),
              torch.randn(R, S, N_PE + 8))
        calls = [lambda: M.march_coarse(*xs, d, wrong),
                 lambda: M.march_fine(*xs, *tail)]
    else:
        xs = (torch.randn(R, S, FIN),)
        calls = [lambda: M.march_coarse_x(*xs, d, wrong),
                 lambda: M.march_fine_x(*xs, *tail)]
    for call in calls:
        with pytest.raises(ValueError, match="channel order"):
            call()


# ---------------------------------------------------------------------------
# samplers and the field
# ---------------------------------------------------------------------------

def test_grid_sample_2d_and_triplane_match_jax():
    """grid_sample_2d (zeros padding, points inside, on the border and
    outside) and sample_from_triplane vs the JAX functions: float32,
    atol 1e-5 (the four corners are summed in another order)."""
    rng = np.random.RandomState(6)
    feat = rng.randn(2, 9, 11, 5).astype(np.float32)
    coords = (rng.rand(2, 200, 2).astype(np.float32) * 2.6 - 1.3)
    coords[:, :4] = [[-1, -1], [1, 1], [-1, 1], [0, 0]]
    want = JGS.grid_sample_2d(jnp.asarray(feat), jnp.asarray(coords))
    got = TGS.grid_sample_2d(_t(feat), _t(coords))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)

    planes = rng.randn(2, 2, 8, 8, 6).astype(np.float32)
    pts = rng.rand(2, 100, 3).astype(np.float32) * 2.4 - 1.2
    want = JGS.sample_from_triplane(jnp.asarray(pts), jnp.asarray(planes))
    got = TGS.sample_from_triplane(_t(pts), _t(planes))
    assert got.shape == want.shape == (2, 100, 6, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)

    # bf16 features: the f32 corner sum is rounded once, to bf16
    got16 = TGS.grid_sample_2d(_t(feat).bfloat16(), _t(coords))
    want16 = JGS.grid_sample_2d(jnp.asarray(feat, jnp.bfloat16),
                                jnp.asarray(coords))
    assert got16.dtype == torch.bfloat16
    np.testing.assert_allclose(got16.float().numpy(),
                               np.asarray(want16, np.float32),
                               atol=2e-2, rtol=1e-2)


FIELD_KW = dict(num_encoding_fn_xyz=4, latent_code_dim=20, plane_feat_dim=16,
                plane_res=32, cond_res=64, plane_middle_size=8, feat_dim=16)


def _field_pair(enc_mode, rng):
    """A JAX field's own initialisation and the port's field holding it.
    The two-head generator splits at 32^2, so its planes are 64^2."""
    kw = dict(FIELD_KW, plane_res=64 if enc_mode == "two_head" else 32)
    j = JF.DoublePlaneNeRFField(enc_mode=enc_mode, **kw)
    B = 1
    lat = (rng.randn(B, 8) * .5).astype(np.float32)
    cond_c = (rng.randn(B, 12) * .3).astype(np.float32)
    conds = [rng.rand(B, 64, 64, 7).astype(np.float32) for _ in range(3)]

    def init(key):
        def run(m):
            planes = m.generate_planes(jnp.asarray(lat), jnp.asarray(cond_c),
                                       *map(jnp.asarray, conds))
            return m(jnp.zeros((B, 4, 3)), None, planes)
        return nn_init(j, run, key)

    variables = jax.jit(init)(jax.random.PRNGKey(11))
    t = TF.DoublePlaneNeRFField(enc_mode=enc_mode, **kw)
    sd = from_jax_params({"params": {"field": variables["params"]}})
    t.load_state_dict({k[len("model_coarse."):]: v for k, v in sd.items()},
                      strict=True)
    return j, variables, t.eval(), (lat, cond_c, conds)


def nn_init(module, fn, key):
    import flax.linen as fnn

    return fnn.init(fn, module)(key)


def _jax_planes(j, variables, lat, cond_c, conds):
    return jax.jit(functools.partial(
        j.apply, method=JF.DoublePlaneNeRFField.generate_planes))(
            variables, jnp.asarray(lat), jnp.asarray(cond_c),
            *map(jnp.asarray, conds))


@pytest.mark.parametrize("enc_mode", ["split", "shared_backbone", "two_head"])
def test_field_matches_jax_in_every_enc_mode(enc_mode):
    """generate_planes, field_inputs and forward of each plane-encoder
    variant vs JAX through from_jax_params; detect_nerf_enc_mode names the
    variant from the port's state_dict. float32: planes atol 2e-4 (the
    generators sum ~10^3 products per output in another order),
    field_inputs and the radiance atol 1e-5 on the same planes."""
    rng = np.random.RandomState(12)
    j, variables, t, (lat, cond_c, conds) = _field_pair(enc_mode, rng)
    want_planes = _jax_planes(j, variables, lat, cond_c, conds)
    with torch.no_grad():
        planes = t.generate_planes(_t(lat), _t(cond_c), *map(_t, conds))
    res = 64 if enc_mode == "two_head" else 32
    assert planes.shape == want_planes.shape == (2, 1, res, res, 16)
    np.testing.assert_allclose(planes.numpy(), np.asarray(want_planes),
                               atol=2e-4, rtol=1e-4)
    sd = {f"model_coarse.{k}": v for k, v in t.state_dict().items()}
    assert detect_nerf_enc_mode(sd) == enc_mode

    pts = (rng.rand(1, 300, 3).astype(np.float32) * 3.4 - 1.7)
    jplanes = jnp.asarray(want_planes)
    want_x = j.apply(variables, jnp.asarray(pts), jplanes,
                     method=JF.DoublePlaneNeRFField.field_inputs)
    want_r = j.apply(variables, jnp.asarray(pts), None, jplanes)
    with torch.no_grad():
        got_x = t.field_inputs(_t(pts), _t(want_planes))
        got_r = t(_t(pts), None, _t(want_planes))
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), atol=1e-5)
    np.testing.assert_allclose(got_r.numpy(), np.asarray(want_r), atol=1e-5,
                               rtol=1e-5)


def test_two_head_generator_matches_jax():
    """TwoHeadPlaneGenerator alone, with its own widths (trunk 8 -> 16, two
    heads 16 -> 32): float32, atol 2e-4 as for the planes above."""
    rng = np.random.RandomState(13)
    kw = dict(out_ch=8, out_size=32, style_dim=12, n_mlp=2, middle_size=8,
              split_size=16, inp_size=64, inp_ch=(7, 13))
    z = rng.randn(2, 12).astype(np.float32)
    cf = rng.rand(2, 64, 64, 7).astype(np.float32)
    cs = rng.rand(2, 64, 64, 13).astype(np.float32)
    j = JG.TwoHeadPlaneGenerator(**kw)
    params = jax.jit(j.init)(jax.random.PRNGKey(2), jnp.asarray(z),
                             jnp.asarray(cf), jnp.asarray(cs))["params"]
    want = jax.jit(j.apply)({"params": params}, jnp.asarray(z),
                            jnp.asarray(cf), jnp.asarray(cs))
    t = TG.TwoHeadPlaneGenerator(**kw)
    sd = from_jax_params({"params": {"field": {"XY_gen": params}}})
    t.load_state_dict({k[len("model_coarse.XY_gen."):]: v
                       for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        got = t.eval()(_t(z), _t(cf).permute(0, 3, 1, 2),
                       _t(cs).permute(0, 3, 1, 2))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(w), atol=2e-4, rtol=1e-4)
    with pytest.raises(ValueError, match="split_size"):
        TG.TwoHeadPlaneGenerator(out_ch=8, out_size=16, split_size=16)


# ---------------------------------------------------------------------------
# the renderer
# ---------------------------------------------------------------------------

TINY = dict(latent_code_dim=8, plane_feat_dim=64, plane_res=32, cond_res=32,
            plane_middle_size=8, skin_vol_res=16, render_size=8)
OUT_KEYS = ("rgb_coarse", "depth_coarse", "acc_coarse", "weights_max",
            "rgb_fine", "depth_fine", "acc_fine")


def _head_T(rng):
    a = rng.randn() * 0.2
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c],
                     rng.randn(3) * 0.05], np.float32)[None]


def _tiny_scene(rng, R=64):
    rays = np.concatenate([
        rng.randn(1, R, 3) * 0.1 + [0, -0.1, 3.0],
        rng.randn(1, R, 3) * 0.15 + [0, 0, -1.0],
        np.full((1, R, 1), 1.4), np.full((1, R, 1), 4.0)],
        -1).astype(np.float32)
    return dict(rays=rays, bg=rng.rand(1, R, 3).astype(np.float32),
                latent=(rng.randn(1, 8) * .5).astype(np.float32),
                inv_T=_head_T(rng),
                conds=[rng.rand(1, 32, 32, 7).astype(np.float32)
                       for _ in range(3)])


@functools.lru_cache(maxsize=None)
def _tiny_pair():
    """A tiny JAX renderer's own initialisation, its scene, and a factory
    for port renderers holding the same weights."""
    rng = np.random.RandomState(20)
    sc = _tiny_scene(rng)
    j = JR.AvatarRenderer(**TINY)
    variables = jax.jit(functools.partial(
        j.init, num_coarse=4, num_fine=2, perturb=False))(
            jax.random.PRNGKey(3), jnp.asarray(sc["rays"][:, :8]),
            jnp.asarray(sc["bg"][:, :8]), jnp.asarray(sc["latent"]),
            jnp.asarray(sc["inv_T"]), *map(jnp.asarray, sc["conds"]))
    sd = from_jax_params(variables)

    def port(**kw):
        t = TR.AvatarRenderer(**TINY, **kw)
        t.load_state_dict(sd, strict=True)
        return t.eval()

    return variables, sc, port


def _jax_render(variables, sc, num_coarse, num_fine, **kw):
    j = JR.AvatarRenderer(**TINY, **kw)
    fn = jax.jit(functools.partial(j.apply, num_coarse=num_coarse,
                                   num_fine=num_fine, perturb=False))
    return fn(variables, jnp.asarray(sc["rays"]), jnp.asarray(sc["bg"]),
              jnp.asarray(sc["latent"]), jnp.asarray(sc["inv_T"]),
              *map(jnp.asarray, sc["conds"]))


def _port_args(sc):
    return tuple(_t(sc[k]) for k in ("rays", "bg", "latent", "inv_T")) + \
        tuple(_t(c) for c in sc["conds"])


def _rays_close(got, want, atol, rtol, name, loose=1e-2, max_rays=1):
    """[1, R, C] outputs agree to (atol, rtol) on every ray but at most
    ``max_rays``, which agree to ``loose``.

    The reference's inverse CDF is ill-conditioned at u = 1: the last fine
    sample sits at the last bin's end when the float32 cumsum of the pdf
    ends at or below 1, and is interpolated inside that bin, at
    1 - (cdf_end - 1) / pdf_last, when it ends one ulp above. JAX and
    PyTorch round that sum differently. On a ray whose last bin is nearly
    empty (pdf_last ~ 1e-4) the sample then moves by 1e-3 of a bin between
    the two sides, and the positional encoding's top frequency (2^7) turns
    that into a visibly different radiance for that one sample (measured on
    one ray in 64: depth 4.7e-3, colour 6.5e-4 apart, with identical field
    values at identical points)."""
    bad = np.abs(got - want) > atol + rtol * np.abs(want)
    rays = np.unique(np.nonzero(bad)[1])
    assert len(rays) <= max_rays, (name, rays)
    np.testing.assert_allclose(got, want, atol=loose, rtol=rtol,
                               err_msg=name)


@pytest.mark.parametrize("num_fine", [4, 0])
def test_exact_render_matches_jax_xla_path(num_fine):
    """The exact path (plain dense chain + volume_render_radiance_field)
    vs the JAX renderer's XLA path on a tiny config, every key of the output
    dict: float32, atol 1e-5, rtol 1e-4 on the coarse pass's colours,
    accumulation and weights. The fine depths are an inverse CDF of the
    coarse weights, which carries their last-bit differences into the fine
    samples' positions: 5e-5 on the fine pass (measured 4e-5 on one ray in
    64). The feature channels of the rgb maps and the depths carry larger
    values summed in another order: atol 1e-4. One ray of the fine pass may
    sit on the inverse CDF's jump (``_rays_close``)."""
    variables, sc, port = _tiny_pair()
    want = _jax_render(variables, sc, 8, num_fine)
    with torch.no_grad():
        got = port()(*_port_args(sc), num_coarse=8, num_fine=num_fine)
    assert set(got) == set(want) == set(OUT_KEYS)
    for k in OUT_KEYS:
        if want[k] is None:
            assert got[k] is None, k
            continue
        w, g = np.asarray(want[k]), got[k].numpy()
        assert g.shape == w.shape, k
        fine = num_fine and (k.endswith("fine") or k == "weights_max")
        tight = 5e-5 if fine else 1e-5
        close = (_rays_close if fine else functools.partial(
            _rays_close, max_rays=0))
        if k.startswith("rgb"):
            close(g[..., :3], w[..., :3], tight, 1e-4, k)
        atol = 1e-4 if k.startswith(("rgb", "depth")) else tight
        close(g, w, atol, 1e-4, k)


def test_exact_render_reproduces_the_tiny_golden():
    """tests/golden/renderer_tiny.npz: the JAX package's fixed-seed tiny
    render. Its inputs and weights are remade here with the same jax.random
    calls and carried across; the port's exact path is held to the bound the
    JAX package holds itself to (atol 1e-4, rtol 1e-3)."""
    kw = dict(latent_code_dim=8, plane_feat_dim=16, plane_res=16,
              cond_res=32, plane_middle_size=4, feat_dim=16, render_size=4,
              skin_vol_res=8)
    B, R = 1, 16
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(1234), 3)
    rays = jnp.concatenate([
        jax.random.normal(k1, (B, R, 3)) * 0.1,
        jax.random.normal(k2, (B, R, 3)) * 0.05 + jnp.asarray([0., 0., -1.]),
        jnp.full((B, R, 1), 1.4), jnp.full((B, R, 1), 4.0)], -1)
    bg = jnp.full((B, R, 3), 0.5)
    latent = jnp.full((B, 8), 0.1)
    inv_T = jnp.broadcast_to(jnp.concatenate(
        [jnp.eye(3), jnp.full((1, 3), 0.05)], 0), (B, 4, 3))
    conds = [jax.random.uniform(jax.random.fold_in(k3, i), (B, 32, 32, 7))
             for i in range(3)]
    params = jax.jit(functools.partial(
        JR.AvatarRenderer(**kw).init, num_coarse=6, num_fine=3,
        perturb=False))(jax.random.PRNGKey(7), rays, bg, latent, inv_T,
                        *conds)
    t = TR.AvatarRenderer(**kw)
    t.load_state_dict(from_jax_params(params), strict=True)
    with torch.no_grad():
        got = t.eval()(*(_t(a) for a in (rays, bg, latent, inv_T, *conds)),
                       num_coarse=6, num_fine=3)
    want = dict(np.load(tiny_golden.GOLDEN))
    assert set(want) == {"rgb_coarse", "rgb_fine", "acc_fine", "depth_fine"}
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], atol=1e-4,
                                   rtol=1e-3, err_msg=k)


def _golden_render(g, idx, **kw):
    r = TR.AvatarRenderer(**kw)
    r.load_state_dict(from_jax_params({k: g[k] for k in g.files
                                       if k.startswith(("field.", "skin."))}),
                      strict=False)
    r.eval()
    with torch.no_grad():
        vol = TS.fix_canonical_volume(r.skin_volume())
        out = r.render_rays(_t(g["planes"]).to(r.compute_dtype),
                            _t(g["rays"])[:, idx], _t(g["bg"])[:, idx],
                            _t(g["inv_head_T"]),
                            num_coarse=int(g["num_coarse"]),
                            num_fine=int(g["num_fine"]), fixed_volume=vol)
    return out["rgb_fine"].float().numpy()


def _psnr(got, want):
    mse = np.mean((np.clip(got[..., :3], 0, 1)
                   - np.clip(want[..., :3], 0, 1)) ** 2)
    return float(10.0 * np.log10(1.0 / max(float(mse), 1e-20)))


@pytest.mark.parametrize("config", ["exact", "fused_reduced_input"])
def test_production_golden_subset_f32(config):
    """Every 32nd ray of tests/golden/render_production.npz at the full
    64 + 16 depth, in float32, through the exact path and through the fused
    march on the reduced input: both held to the bound the JAX package holds
    its own render to (test_production_golden._check: >= 55 dB, atol 5e-3,
    rtol 1e-2)."""
    g = golden._load()
    want = g["render"].reshape(1, -1, g["render"].shape[-1])
    idx = np.arange(0, want.shape[1], 32)
    kw = ({} if config == "exact"
          else dict(use_fused_march=True, use_quad_march=False))
    golden._check(_golden_render(g, idx, **kw), want[:, idx])


def test_render_chunked_equals_render_rays():
    """render_chunked over 4 chunks of 16 rays equals one render over all
    64 (each ray is independent: identical up to float32 batching of the
    matmuls, atol 1e-6), and refuses a ray count the chunk does not
    divide."""
    variables, sc, port = _tiny_pair()
    r = port()
    with torch.no_grad():
        whole = r(*_port_args(sc), num_coarse=8, num_fine=4)
        parts = r.render_chunked(*_port_args(sc), chunk_size=16,
                                 num_coarse=8, num_fine=4)
        coarse_only = r.render_chunked(*_port_args(sc), chunk_size=32,
                                       num_coarse=8, num_fine=0)
    for k in OUT_KEYS:
        torch.testing.assert_close(parts[k], whole[k], atol=1e-6, rtol=1e-6)
    assert coarse_only["rgb_fine"] is None
    assert coarse_only["rgb_coarse"].shape == (1, 64, 67)
    with pytest.raises(ValueError, match="chunk_size"):
        r.render_chunked(*_port_args(sc), chunk_size=48)


def test_reduced_input_fused_render_matches_jax():
    """The fused march on the reduced input (twins here) vs the JAX renderer
    with use_pallas_march=True, use_pallas_quad=False (Pallas in interpret
    mode), float32, tiny config, every output key: atol 5e-5 (the
    transmittance is a direct product here and exp(sum(log)) there, which
    moves the fine depths by float32 rounding), feature channels and depths
    atol 2e-4; one ray may sit on the inverse CDF's jump (``_rays_close``).
    It also agrees with the port's quad configuration to the same bound:
    same points, layer0 summed in another order."""
    variables, sc, port = _tiny_pair()
    want = _jax_render(variables, sc, 16, 4, use_pallas_march=True,
                       use_pallas_quad=False)
    with torch.no_grad():
        got = port(use_fused_march=True, use_quad_march=False)(
            *_port_args(sc), num_coarse=16, num_fine=4)
        quad = port(use_fused_march=True)(*_port_args(sc), num_coarse=16,
                                          num_fine=4)
    for k in OUT_KEYS:
        w, g = np.asarray(want[k]), got[k].numpy()
        if k.startswith("rgb"):
            _rays_close(g[..., :3], w[..., :3], 5e-5, 0.0, k)
        atol = 2e-4 if k.startswith(("rgb", "depth")) else 5e-5
        _rays_close(g, w, atol, 1e-4, k)
        _rays_close(g, quad[k].numpy(), atol, 1e-4, f"{k} vs quad")


def test_reduced_input_fused_bf16_against_jax_on_the_golden_subset():
    """bf16, what the CUDA kernels compute: the port's reduced-input fused
    path on the golden subset is no more than 1 dB below the JAX renderer's
    (use_pallas_quad=False, bf16, interpret mode), the bound
    tests/test_torch_frame.py puts on the quad configuration."""
    g = golden._load()
    want = g["render"].reshape(1, -1, g["render"].shape[-1])
    idx = np.arange(0, want.shape[1], 32)
    _, variables, vol = golden._build(g)
    j = JR.AvatarRenderer(use_pallas_march=True, use_pallas_quad=False,
                          compute_dtype="bfloat16")
    render = jax.jit(functools.partial(
        j.apply, num_coarse=int(g["num_coarse"]), num_fine=int(g["num_fine"]),
        perturb=False, method=JR.AvatarRenderer.render_rays))
    out = render(variables, jnp.asarray(g["planes"], jnp.bfloat16),
                 jnp.asarray(g["rays"])[:, idx], jnp.asarray(g["bg"])[:, idx],
                 jnp.asarray(g["inv_head_T"]), fixed_volume=vol)
    jax_db = _psnr(np.asarray(out["rgb_fine"], np.float32), want[:, idx])
    port_db = _psnr(_golden_render(g, idx, compute_dtype=torch.bfloat16,
                                   use_fused_march=True,
                                   use_quad_march=False), want[:, idx])
    assert port_db >= jax_db - 1.0, (port_db, jax_db)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("kwargs", [dict(perturb=True),
                                    dict(radiance_field_noise_std=0.1),
                                    dict(rng=0)])
def test_stochastic_arguments_raise(kwargs, fused):
    """perturb and sigma noise draw random numbers: asking for one without
    an rng raises in every configuration instead of rendering without it,
    and so does an rng that is neither a torch.Generator nor the draws
    themselves (tests/test_torch_train.py renders with both)."""
    _, sc, port = _tiny_pair()
    r = port(use_fused_march=fused)
    error = TypeError if "rng" in kwargs else ValueError
    with pytest.raises(error, match="rng"):
        r(*_port_args(sc), num_coarse=4, num_fine=2, **kwargs)
    with pytest.raises(error, match="rng"):
        r.render_chunked(*_port_args(sc), chunk_size=16, num_coarse=4,
                         num_fine=2, **kwargs)
