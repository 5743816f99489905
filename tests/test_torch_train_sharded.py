"""The stage-1 loss and its raw gradients on 2 and 4 CPU ranks (``gloo``)
against one process, and a sharded stage-1 loss against havatar_tpu's
one-device loss.

Raw gradients are compared, not parameters after an Adam step: the first
Adam step does not depend on a gradient's scale, so a missing 1/N or a
replicated term counted N times would hide there. Every rank builds the
same weights (torch's default initialization from seed 0) and reads the
same global batch, takes its block (the rays split on axis 1, or the frames
on axis 0 with ``frame_parallel``), and runs the loss, backward and
``comm.all_reduce_grads`` (``tests/torch_dist.py:stage1_worker``). One
rank of each run also computes a case's one-process loss on the whole
batch, each case on another rank. Sample noise, with ``perturb`` and
sigma noise on: seeded draws for the whole batch, which each rank cuts to
its block, so that the sharded and the one-process loss see the same
numbers.

Bounds: the gathered render and the loss are the one-process ones up to
float32 summation order (the blocks' products and the all-reduce add in
another order), so losses and metrics agree to 1e-6 relative (metrics 1e-6
absolute too) and every gradient tensor to 1e-5 of its largest entry (plus
1e-9). The sharded loss against JAX's one-device loss:
``tests/test_train_steps.py:117-147``'s bounds (atol and rtol 1e-5 on the
loss and its terms).
"""

import functools
import json
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from havatar_tpu.checkpoints import convert as JConv
from havatar_tpu.train import stage1 as JS1
from havatar_tpu.utils.cfgnode import CfgNode as JCfgNode
from havatar_tpu.utils.cfgnode import load_config as j_load_config
from havatar_tpu_torch.models.renderer import RenderNoise
from havatar_tpu_torch.train import lpips as TL
from havatar_tpu_torch.utils.cfgnode import CfgNode

sys.path.insert(0, os.path.dirname(__file__))
import torch_dist  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "tests", "configs", "tiny.yml")
# tiny.yml at smaller conditions and planes (the plane generators' 512
# channels make the step's cost)
SMALL = {"dataset.cond_render_res": 32, "models.coarse.plane_res": 16,
         "models.coarse.plane_middle_size": 4}
ROUTES = {"plain": {}, "quad": {"models.use_pallas_mlp_quad": True}}
MODES = {"rays": 2, "frames": 4}        # frames of 16 rays in the batch
JAX_CASE = {"nerf.train.perturb": False,
            "nerf.train.radiance_field_noise_std": 0.0,
            "experiment.patch_rgb": True}
LOSS_RTOL = 1e-6
GRAD_REL, GRAD_ATOL = 1e-5, 1e-9


def _cfg(**over):
    """tiny.yml as a plain dict for both packages, with ``SMALL`` and
    dotted-key overrides."""
    cfg = json.loads(json.dumps(j_load_config(TINY)))
    for dotted, v in {**SMALL, **over}.items():
        node = cfg
        *path, leaf = dotted.split(".")
        for part in path:
            node = node[part]
        node[leaf] = v
    return cfg


def _batch(B: int, R: int, res: int, seed: int = 0) -> dict:
    """tests/test_train_steps.py:tiny_batch's layout from a numpy seed:
    rays from near the origin towards -z, near/far 1.4/4.0, background,
    ray mask."""
    rng = np.random.RandomState(seed)
    rays = np.concatenate([
        rng.randn(B, R, 3) * 0.1, rng.randn(B, R, 3) * 0.05 + [0, 0, -1],
        np.full((B, R, 1), 1.4), np.full((B, R, 1), 4.0), rng.rand(B, R, 3),
        rng.rand(B, R, 1) > 0.5], -1)
    eye = np.concatenate([np.eye(3), np.zeros((1, 3))], 0)
    out = {"mv_rays": rays, "gt_color": rng.rand(B, R, 3),
           "dataset_idx": np.arange(B) % 2,
           "inv_head_T": np.broadcast_to(eye, (B, 4, 3)).copy()}
    for k in ("front_render_cond", "left_render_cond", "right_render_cond"):
        out[k] = rng.rand(B, res, res, 7)
    return {k: v.astype(np.int64 if k == "dataset_idx" else np.float32)
            for k, v in out.items()}


def _draws(cfg: dict, B: int, R: int) -> RenderNoise:
    """Seeded draws of a whole-batch render (render_rays' four)."""
    rng = np.random.RandomState(7)
    nc, nf = cfg["nerf"]["train"]["num_coarse"], cfg["nerf"]["train"][
        "num_fine"]
    return RenderNoise(*(torch.from_numpy(a.astype(np.float32)) for a in (
        rng.rand(B, R, nc), rng.randn(B * R, nc), rng.rand(B * R, nf),
        rng.randn(B * R, (nc + 1) // 2 + nf))))


LATENT = (np.random.RandomState(5).randn(2, 8) * 0.3).astype(np.float32)


def _cases() -> dict:
    """name -> (cfg dict, global batch, global draws, frame_parallel,
    lpips): the route x mode cases, and the JAX-parity case ``jax_patch``
    (perturb and noise off, one 16 x 16 patch a frame with the LPIPS term
    on seeded VGG weights)."""
    cases = {}
    for route, over in ROUTES.items():
        cfg = _cfg(**over)
        for mode, B in MODES.items():
            cases[f"{mode}/{route}"] = (cfg, _batch(B, 16, 32),
                                        _draws(cfg, B, 16), mode == "frames",
                                        None)
    lpips = TL.init_lpips_params(torch.Generator().manual_seed(9))
    cases["jax_patch"] = (_cfg(**JAX_CASE), _batch(2, 256, 32, seed=1),
                          None, False, lpips)
    return cases


def _jax_loss(case) -> tuple:
    """havatar_tpu's one-device make_loss_fn on the case's batch, with the
    port's seed-0 weights carried over by havatar_tpu's own converter
    (bound to tiny.yml's skinning volume) and the case's LPIPS weights."""
    cfg_dict, batch, _, _, lpips = case
    state = torch_dist.stage1_state(CfgNode(cfg_dict), LATENT)
    jcfg = JCfgNode(cfg_dict)
    mp = pytest.MonkeyPatch()
    mp.setattr(JConv, "convert_volume_decoder", functools.partial(
        JConv.convert_volume_decoder,
        final_res=cfg_dict["models"]["coarse"]["skin_vol_res"]))
    try:
        conv = JConv.convert_renderer(state.renderer.state_dict())[
            "variables"]
    finally:
        mp.undo()
    model = JS1.build_renderer(jcfg)
    lp = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), lpips)
    jl, jm = jax.jit(JS1.make_loss_fn(model, jcfg, lp))(
        (conv["params"], jnp.asarray(LATENT)), conv["buffers"],
        {k: jnp.asarray(v) for k, v in batch.items()}, None)
    return float(jl), {k: float(v) for k, v in jm.items()}


@pytest.fixture(scope="module")
def stage1(tmp_path_factory):
    """world -> every rank's results (the JAX-parity case at world 2)."""
    cases = _cases()
    runs = {}

    def get(world):
        if world not in runs:
            runs[world] = torch_dist.run_ranks(
                torch_dist.stage1_worker, world,
                str(tmp_path_factory.mktemp(f"s1_{world}")),
                {k: v for k, v in cases.items()
                 if world == 2 or k != "jax_patch"}, LATENT)
        return runs[world]
    get.cases = cases
    return get


def assert_sharded_equals_single(outs: list, name: str) -> None:
    """The one-process loss, metrics and gradients (from the rank that ran
    them) against the sharded ones: losses and metrics on every rank,
    gradients on that rank, with every rank's gradient checksum equal."""
    res0 = next(out[name] for out in outs if "single" in out[name])
    loss1, metrics1 = res0["single"]
    losses = [out[name]["loss"] for out in outs]
    assert np.mean(losses) == pytest.approx(loss1, rel=LOSS_RTOL)
    for out in outs:
        assert set(out[name]["metrics"]) == set(metrics1)
        for k, v in metrics1.items():
            assert out[name]["metrics"][k] == pytest.approx(
                v, rel=LOSS_RTOL, abs=1e-6), (name, k)
        assert out[name]["checksum"] == res0["checksum"], name
    held = 0
    for param, e in res0["errors"].items():
        if e is not None:
            err, scale = e
            assert err <= GRAD_REL * scale + GRAD_ATOL, (name, param, e)
            held += 1
    assert held > 100, held


@pytest.mark.parametrize("world", (2, 4))
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("route", ROUTES)
def test_stage1_sharded_gradients_equal_one_process(stage1, world, mode,
                                                    route):
    """make_loss_fn(mesh=...) on each rank's block (the rays, or the frames
    with frame_parallel) and all_reduce_grads: the loss (every rank's on
    the rays; the mean of the ranks' on the frames), every metric, and the
    raw gradient of every renderer parameter and of the latent codes equal
    the one-process ones on the whole batch, on every rank. Both the plain
    dense chain and the fused quad op (its twin here)."""
    outs = stage1(world)
    name = f"{mode}/{route}"
    if mode == "rays":
        assert [out[name]["loss"] for out in outs] == \
            [outs[0][name]["loss"]] * world
    assert_sharded_equals_single(outs, name)


def test_stage1_sharded_loss_matches_jax(stage1):
    """The ray-sharded loss at world 2, perturb and noise off, the patch
    LPIPS term on (each frame's 16 x 16 patch is gathered before LPIPS),
    against havatar_tpu's one-device make_loss_fn on the same weights and
    batch: the loss and its terms within atol and rtol 1e-5
    (tests/test_train_steps.py:117-147); its gradients equal one
    process's."""
    jl, jm = _jax_loss(stage1.cases["jax_patch"])
    outs = stage1(2)
    for out in outs:
        res = out["jax_patch"]
        assert res["metrics"]["patch_percep_loss"] > 0
        np.testing.assert_allclose(res["loss"], jl, atol=1e-5, rtol=1e-5)
        for key in ("loss", "coarse_loss", "fine_loss", "mask_coarse_loss",
                    "mask_fine_loss", "patch_percep_loss", "code_loss"):
            np.testing.assert_allclose(res["metrics"][key], jm[key],
                                       atol=1e-5, rtol=1e-5, err_msg=key)
    assert_sharded_equals_single(outs, "jax_patch")
