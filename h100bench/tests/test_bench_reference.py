"""The plain reference agrees with the program's own plain paths (the
kernels' twins on the CPU) at tiny widths, on the same seeded weights,
inputs and draws."""

from __future__ import annotations

import pytest
import torch

from h100bench import generate
from h100bench.drivers.training import Record, leaves_of
from h100bench.reference import steps as ref
from h100bench.tests import tinycell
from h100bench.weights import fill_, generator, lpips_params

CPU = tinycell.CPU


def _cfg(name):
    from havatar_tpu_torch.utils.cfgnode import CfgNode
    cell = tinycell.cell(name)
    return cell, CfgNode(cell.config["config"])


def _close(a, b, tol=1e-5):
    a, b = a.float(), b.float()
    assert (a - b).abs().max() <= tol * (1 + b.abs().max())


@pytest.fixture(scope="module")
def render_inputs():
    """Two items' full-size rays with a white background, and their head
    poses, conditions and expression latents, from the generator."""
    cell, _ = _cfg("hd512.train_dg")
    c = cell.config["config"]
    side = c["models"]["StyleUnet"]["inp_size"]
    res = c["dataset"]["cond_render_res"]
    g = generator(CPU, 3, "render")
    rays = generate.camera_rays(side, CPU).expand(2, side * side, 8)
    return cell, {
        "rays": rays.contiguous(), "bg": torch.ones(2, side * side, 3),
        "latent": torch.randn(2, c["experiment"]["latent_code_dim"],
                              generator=g) * 0.1,
        "inv_head_T": generate.head_pose(g, 2, 0.3, 0.05, CPU),
        **{k: torch.rand(2, res, res, 7, generator=g)
           for k in ("front", "left", "right")}}


def test_state_dict_layouts_match():
    from havatar_tpu_torch.models.generators import StyleUNetSR
    from havatar_tpu_torch.train.stage2 import build_models
    cell, cfg = _cfg("hd512.train_dg")
    c = cell.config["config"]
    ours = build_models(cfg)
    theirs = (ref.build_renderer(c), ref.build_generator(c),
              ref.build_discriminator(c))
    for a, b in zip(ours, theirs):
        sa, sb = a.state_dict(), b.state_dict()
        assert list(sa) == list(sb)
        assert all(sa[k].shape == sb[k].shape for k in sa)
        fill_(a, 5, "x")
        fill_(b, 5, "x")
        for k in sa:
            assert torch.equal(sa[k], sb[k]), k
    assert isinstance(ours[1], StyleUNetSR)


def test_render_agrees_with_the_exact_path(render_inputs):
    from havatar_tpu_torch.train.stage1 import build_renderer
    cell, inp = render_inputs
    _, cfg = _cfg("hd512.train_dg")
    ours = fill_(build_renderer(cfg), 3, "renderer").eval()
    theirs = fill_(ref.build_renderer(cell.config["config"]), 3,
                   "renderer").eval()
    args = (inp["rays"], inp["bg"], inp["latent"], inp["inv_head_T"],
            inp["front"], inp["left"], inp["right"])
    with torch.no_grad():
        a = ours(*args, num_coarse=8, num_fine=4)
        b = theirs(*args, num_coarse=8, num_fine=4)
    for k in ("rgb_coarse", "acc_coarse", "rgb_fine", "acc_fine"):
        _close(a[k], b[k])


def test_stage2_first_iteration_agrees():
    from havatar_tpu_torch.train import stage2
    cell, cfg = _cfg("hd512.train_dg")
    c, tr = cell.config["config"], cell.traffic
    models = stage2.build_models(cfg)
    for m, tag in zip(models, ("renderer", "generator", "discriminator")):
        fill_(m, 4, tag)
    state = stage2.init_state(cfg, 8, CPU, models)
    lp = lpips_params(CPU, 4)
    d_step, r1_step, g_step, _ = stage2.make_steps(state, cfg, lp)
    theirs = [ref.build_renderer(c), ref.build_generator(c),
              ref.build_discriminator(c)]
    for m, tag in zip(theirs, ("renderer", "generator", "discriminator")):
        fill_(m, 4, tag)
    st = ref.Stage2(c, *theirs, torch.zeros(8, 8), lp)
    batch = generate.stage2_batch(4, 0, tr, cell.config, CPU)
    a = {**d_step(batch, generator(CPU, 4, "rng0")), **r1_step(batch),
         **g_step(batch, generator(CPU, 4, "rng0"))}
    b = {**st.d_step(batch, generator(CPU, 4, "rng0")), **st.r1_step(batch),
         **st.g_step(batch, generator(CPU, 4, "rng0"))}
    for k in ("d", "nerf_loss", "hr_l1", "percep"):
        assert float(a[k]) == pytest.approx(b[k], rel=1e-5)
    ra = Record(leaves_of(state.renderer, state.latent_codes,
                          generator=state.generator))
    rb = Record(leaves_of(st.renderer, st.latent_codes, generator=st.gen))
    ra.first_grad("generator", state.g_opt)
    rb.first_grad("generator", st.g_opt)
    for leaf, w in rb.grad["generator"].items():
        assert ra.grad["generator"][leaf] == pytest.approx(w, rel=1e-3,
                                                           abs=1e-8)


def test_stage1_step_agrees():
    from havatar_tpu_torch.train import stage1
    cell, cfg = _cfg("base512.train_s1")
    c, tr = cell.config["config"], cell.traffic
    renderer = fill_(stage1.build_renderer(cfg), 6, "renderer")
    state = stage1.init_state(cfg, 8, CPU, renderer)
    lp = lpips_params(CPU, 6)
    step = stage1.make_train_step(state, cfg, lp)
    st = ref.Stage1(c, fill_(ref.build_renderer(c), 6, "renderer"),
                    torch.zeros(8, 8), lp)
    for i in range(2):
        batch = generate.stage1_batch(6, i, tr, cell.config, CPU)
        a = step(batch, generator(CPU, 6, f"rng{i}"))
        b = st.step(batch, generator(CPU, 6, f"rng{i}"))
        assert float(a["loss"]) == pytest.approx(b["loss"], rel=1e-5)
