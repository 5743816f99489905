"""The multi-GPU serving path (``havatar_tpu_torch/infer/serving.py``) on 2
CPU ranks (``gloo``), against havatar_tpu's ``infer/serving.py`` on a
2-device slice of this process's virtual CPU mesh and against the port's
own one-process frame; and ``cli/reenact.py`` under ``torch.distributed.run
--nproc_per_node 2``.

Weights: tests/test_torch_serve.py's seeded tiny_hd checkpoint (its
``scene`` fixture), which havatar_tpu loads through its own converter (its
``jax_side`` fixture). Inputs: the flagship camera at the render's 16^2,
two frames of seeded conditions, the checkpoint's first two latent codes
and JAX's mean style. Both packages march the exact float32 path at the
config's 8 + 4 samples.

Bounds: against JAX, tests/test_torch_serve.py's, on uint8 frames: at most
1 of 255 apart on at most 0.1% of the values (both float32; a value within
rounding of a .5 boundary may round the other way). Against the port's one
process, 1e-6 on the float frames: each rank marches its rays with the
same code, and only the products' blocking can differ.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from havatar_tpu.infer import serving as JS
from havatar_tpu.models.generators import StyleUNetSR as JStyleUNetSR
from havatar_tpu.models.renderer import AvatarRenderer as JAR
from havatar_tpu.models.skinning import fix_canonical_volume
from havatar_tpu.parallel import make_mesh as j_make_mesh
from havatar_tpu.train.stage1 import build_renderer as j_build_renderer
from havatar_tpu_torch.cli import reenact as TCli
from havatar_tpu_torch.cli.common import resolve_config
from havatar_tpu_torch.infer.reenact import flagship_rays

sys.path.insert(0, os.path.dirname(__file__))
import torch_dist  # noqa: E402
from test_torch_serve import TINY_HD, _pngs, jax_side, scene  # noqa: E402,F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = dict(render_size=8, cond_res=32, plane_res=16,
                plane_middle_size=4, sr_out=32, num_coarse=4, num_fine=4)


def _inputs(jax_side) -> dict:
    """Two frames: the flagship camera at 16^2 (the second moved 0.2 to
    the side), white background, seeded conditions, the checkpoint's
    codes, identity head poses, JAX's mean style."""
    cfg = jax_side["cfg"]
    s, c = cfg.models.StyleUnet.inp_size, cfg.dataset.cond_render_res
    rays = np.concatenate([flagship_rays(s)] * 2)
    rays[1, :, 0] += 0.2
    rng = np.random.RandomState(11)
    eye = np.concatenate([np.eye(3), np.zeros((1, 3))], 0)
    out = {"rays": rays, "bg": np.ones(rays.shape[:2] + (3,)),
           "latent": np.asarray(jax_side["latents"][:2]),
           "inv_head_T": np.broadcast_to(eye, (2, 4, 3)).copy(),
           "style": jax_side["style"]}
    for k in ("front", "left", "right"):
        out[k] = rng.rand(2, c, c, 7)
    return {k: np.ascontiguousarray(v, np.float32) for k, v in out.items()}


def _uint8(img) -> np.ndarray:
    return torch.clamp(torch.as_tensor(img) * 255.0, 0.0, 255.0).to(
        torch.uint8).numpy()


@pytest.fixture(scope="module")
def frames(scene, jax_side, tmp_path_factory):
    """(the port's ranks' results, JAX's ray-sharded frame of item 0, JAX's
    frame-parallel frames of both items)."""
    inputs = _inputs(jax_side)
    cfg = resolve_config(TINY_HD)
    ranks = torch_dist.run_ranks(
        torch_dist.serving_worker, 2, str(tmp_path_factory.mktemp("serve")),
        json.loads(json.dumps(cfg)), scene["ckpt"], inputs, FLAGSHIP)

    jcfg = jax_side["cfg"]
    renderer = j_build_renderer(jcfg)
    su, gan = jcfg.models.StyleUnet, jcfg.gan
    sr = JStyleUNetSR(inp_size=su.inp_size, inp_ch=su.inp_ch, out_ch=3,
                      out_size=su.out_size, style_dim=gan.latent,
                      n_mlp=gan.n_mlp,
                      channel_multiplier=gan.channel_multiplier)
    variables, g_ema = jax_side["variables"], jax_side["g_ema"]
    vol = fix_canonical_volume(renderer.apply(variables,
                                              method=JAR.skin_volume))
    mesh = j_make_mesh(("data",), devices=jax.devices()[:2])
    nc, nf = int(jcfg.nerf.validation.num_coarse), int(
        jcfg.nerf.validation.num_fine)
    j = {k: jnp.asarray(v) for k, v in inputs.items()}
    style2 = jnp.broadcast_to(j["style"], (2, j["style"].shape[-1]))
    fn = JS.make_sharded_frame_fn(mesh, renderer, sr, num_coarse=nc,
                                  num_fine=nf, to_uint8=True)
    rays, bg, *rest = JS.place_frame_inputs(
        mesh, j["rays"][:1], j["bg"][:1], variables, g_ema, vol,
        j["latent"][:1], j["inv_head_T"][:1], j["front"][:1],
        j["left"][:1], j["right"][:1], style2[:1])
    nv, gp, v, lat, it, f, l, r, st = rest
    sharded = np.asarray(fn(nv, gp, v, rays, bg, lat, it, f, l, r, st))
    fn = JS.make_frame_parallel_fn(mesh, renderer, sr, num_coarse=nc,
                                   num_fine=nf, to_uint8=True)
    rays, bg, lat, it, f, l, r, st, nv, gp, v = JS.place_batch_inputs(
        mesh, (j["rays"], j["bg"], j["latent"], j["inv_head_T"],
               j["front"], j["left"], j["right"], style2),
        (variables, g_ema, vol))
    parallel = np.asarray(fn(nv, gp, v, rays, bg, lat, it, f, l, r, st))
    return ranks, sharded, parallel


def _close_to_jax(got: np.ndarray, want: np.ndarray, where: str) -> None:
    assert got.shape == want.shape, where
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1, (where, diff.max())
    assert (diff > 0).mean() <= 1e-3, (where, (diff > 0).mean())
    # real values, not frames clamped to 0 or 255
    assert ((want > 0) & (want < 255)).mean() > 0.2, where


def test_ray_sharded_frame_matches_jax_and_one_process(frames):
    """make_sharded_frame_fn at world 2 (each rank marches 128 of the 256
    rays, the rgb + feature rows are gathered, SR runs on both): both ranks
    hold the whole 64^2 frame, equal to JAX's make_sharded_frame_fn on 2
    devices at the uint8 bound and to the port's one-process frame within
    1e-6."""
    ranks, sharded, _ = frames
    single = ranks[0]["single"][:1]
    for out in ranks:
        got = out["ray_sharded"]
        assert got.shape == (1, 64, 64, 3)
        torch.testing.assert_close(got, single, atol=1e-6, rtol=0)
        _close_to_jax(_uint8(got), sharded, "ray-sharded")


def test_frame_parallel_frames_match_jax_and_one_process(frames):
    """make_frame_parallel_fn at world 2 on two frames: rank r returns frame
    r, no collective; together they are JAX's make_frame_parallel_fn
    output on 2 devices (uint8 bound) and the port's one-process frames
    within 1e-6; the two frames differ."""
    ranks, _, parallel = frames
    got = torch.cat([out["frame_parallel"] for out in ranks])
    assert [tuple(out["frame_parallel"].shape) for out in ranks] == [
        (1, 64, 64, 3)] * 2
    torch.testing.assert_close(got, ranks[0]["single"], atol=1e-6, rtol=0)
    _close_to_jax(_uint8(got), parallel, "frame-parallel")
    assert not torch.equal(got[0], got[1])


def test_flagship_on_a_mesh_equals_one_process(frames):
    """build_flagship(mesh=...) at tiny sizes, bf16 on the fused march's
    CPU twins: each rank's inputs hold half the 64 rays, and the sharded
    frame equals the one-process flagship's within 1e-6."""
    ranks, _, _ = frames
    want = ranks[0]["flagship_single"]
    for out in ranks:
        assert tuple(out["flagship_rays"]) == (1, 32, 8)
        torch.testing.assert_close(out["flagship_sharded"], want, atol=1e-6,
                                   rtol=0)


def test_reenact_cli_on_two_ranks(scene, tmp_path, capsys):
    """``python -m torch.distributed.run --nproc_per_node 2 -m
    havatar_tpu_torch.cli.reenact ... --device cpu``: rank 0 alone prints
    the stats and writes the PNGs, which equal the one-process CLI's
    frames (exact precision, 2 cameras x 3 frames) within 1 of 255 on at
    most 0.1% of the values."""
    args = ["--config", TINY_HD, "--ckpt", scene["ckpt"], "--split",
            scene["split"], "--precision", "exact", "--device", "cpu"]
    two, one = str(tmp_path / "two"), str(tmp_path / "one")
    proc = torch_dist.torchrun("havatar_tpu_torch.cli.reenact",
                               args + ["--savedir", two])
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    assert lines.count("Done!") == 1, proc.stdout
    stats = json.loads(lines[lines.index("Done!") - 1])
    TCli.main(args + ["--savedir", one])
    capsys.readouterr()
    got, want = _pngs(two), _pngs(one)
    assert stats["frames"] == len(want) == 6
    assert list(got) == list(want)
    for name in want:
        diff = np.abs(got[name].astype(np.int16) - want[name])
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, name
