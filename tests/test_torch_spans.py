"""The port's profiler spans (``havatar_tpu_torch/utils/profiling.py:span``)
on the CPU at the tiny sizes of tests/test_torch_train_steps.py and
tests/test_torch_stage2_steps.py (``tiny_cfg``, and a batch laid out as
``tiny_batch``'s but drawn by torch: JAX's draws cost seconds of compiles).

Without a profiler a span is one shared no-op object; under
``torch.profiler`` each training step emits its ``havatar.*`` ranges where
they belong, and a step's losses and updated parameters do not depend on
whether a profiler runs.
"""

import copy
import functools
import json

import pytest
import torch

from havatar_tpu_torch.train import stage1 as TS1
from havatar_tpu_torch.train import stage2 as TS2
from havatar_tpu_torch.train.lpips import init_lpips_params
from havatar_tpu_torch.utils import profiling
from havatar_tpu_torch.utils.cfgnode import CfgNode as TCfg

from test_train_steps import tiny_cfg

RENDER, GEN = 16, 64         # tests/test_torch_stage2_steps.py's sizes
RENDER_PARTS = {"render", "render.planes", "render.skinning", "render.field"}
EMITTED = {
    "stage1": RENDER_PARTS | {"lpips", "backward", "optim"},
    "d_step": RENDER_PARTS | {"draws", "sr", "disc", "backward", "optim"},
    "r1_step": {"disc", "backward", "optim"},
    "g_step": RENDER_PARTS | {"draws", "sr", "disc", "lpips", "backward",
                              "optim"},
}
CASES = list(EMITTED)


def _cfg(**over):
    c = tiny_cfg()
    for dotted, v in over.items():
        node = c
        *path, leaf = dotted.split(".")
        for part in path:
            node = node[part]
        node[leaf] = v
    return TCfg(json.loads(json.dumps(c)))


@functools.lru_cache(maxsize=None)
def _batch():
    """One item of ``tiny_batch``'s layout: RENDER^2 rays, 32^2
    conditions, GEN^2 target."""
    g = torch.Generator().manual_seed(0)
    R = RENDER * RENDER

    def u(*shape):
        return torch.rand(1, *shape, generator=g)

    rays = torch.cat([
        torch.randn(1, R, 3, generator=g) * 0.1,
        torch.randn(1, R, 3, generator=g) * 0.05
        + torch.tensor([0.0, 0.0, -1.0]),
        torch.full((1, R, 1), 1.4), torch.full((1, R, 1), 4.0),
        u(R, 3), (u(R, 1) > 0.5).float()], -1)
    return {"mv_rays": rays, "gt_color": u(R, 3),
            "dataset_idx": torch.zeros(1, dtype=torch.long),
            "inv_head_T": torch.cat([torch.eye(3), torch.zeros(1, 3)])[None],
            "front_render_cond": u(32, 32, 7),
            "left_render_cond": u(32, 32, 7),
            "right_render_cond": u(32, 32, 7),
            "gt_hr_img": u(GEN, GEN, 3),
            "gt_lr_mask": (u(RENDER, RENDER, 1) > 0.5).float()}


def _lpips():
    return init_lpips_params(torch.Generator().manual_seed(9))


def _params(state, modules):
    out = [p.detach().clone() for m in modules for p in m.parameters()]
    return out + [state.latent_codes.detach().clone()]


def _stage1_run(state, cfg, lpips, batch):
    step = TS1.make_train_step(state, cfg, lpips)
    metrics = step(batch, torch.Generator().manual_seed(1))
    return {"stage1": (metrics, _params(state, [state.renderer]))}


def _stage2_run(state, cfg, lpips, batch):
    """A D, an R1 and a G step in turn, each in a range ``test.<step>``
    -> {step: (metrics, the parameters after it)}."""
    d_step, r1_step, g_step, _ = TS2.make_steps(state, cfg, lpips)
    rng = torch.Generator().manual_seed(1)
    calls = {"d_step": lambda: d_step(batch, rng),
             "r1_step": lambda: r1_step(batch),
             "g_step": lambda: g_step(batch, rng)}
    modules = [state.renderer, state.generator, state.discriminator,
               state.g_ema]
    out = {}
    for name, call in calls.items():
        with torch.profiler.record_function("test." + name):
            metrics = call()
        out[name] = (metrics, _params(state, modules))
    return out


@functools.lru_cache(maxsize=None)
def _pair(stage: int):
    """The steps of ``stage`` on a fresh seeded state under a CPU profiler,
    and on a copy of that state without one -> (each step's ``havatar.*``
    ranges as (name, start_ns, end_ns), both runs' {step: (metrics,
    parameters)}). One item a step: the spans do not depend on the batch.
    On one thread: the CPU's threaded index accumulation in the backward
    sums in no fixed order, and the tests' workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        torch.manual_seed(0)
        if stage == 1:
            cfg = _cfg(**{"experiment.patch_rgb": True})
            state, run = TS1.init_state(cfg, 2, "cpu"), _stage1_run
        else:
            cfg = _cfg(**{"models.StyleUnet.inp_size": RENDER,
                          "models.StyleUnet.out_size": GEN})
            state, run = TS2.init_state(cfg, 2, "cpu"), _stage2_run
        plain_state, lpips = copy.deepcopy(state), _lpips()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            profiled = run(state, cfg, lpips, _batch())
        plain = run(plain_state, cfg, lpips, _batch())
    finally:
        torch.set_num_threads(threads)
    events = prof.profiler.kineto_results.events()
    steps = {e.name()[len("test."):]: (e.start_ns(), e.end_ns())
             for e in events if e.name().startswith("test.")}
    ranges = [(e.name()[len(profiling.PREFIX):], e.start_ns(), e.end_ns())
              for e in events if e.name().startswith(profiling.PREFIX)]
    by_step = {name: [r for r in ranges if a <= r[1] and r[2] <= b]
               for name, (a, b) in steps.items()} or {"stage1": ranges}
    return by_step, profiled, plain


def _case(case: str):
    by_step, profiled, plain = _pair(1 if case == "stage1" else 2)
    return by_step[case], profiled[case], plain[case]


def test_span_without_profiler_is_one_shared_noop():
    assert not torch._C._autograd._profiler_enabled()
    a, b = profiling.span("render"), profiling.span("optim")
    assert a is b
    with a:
        pass
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        on = profiling.span("render")
        assert on is not a
        assert isinstance(on, torch.profiler.record_function)
    assert profiling.span("render") is a


@pytest.mark.parametrize("case", CASES)
def test_step_emits_its_spans_under_the_profiler(case):
    """Each step emits exactly its parts; the renderer's parts nest inside
    ``render``; the stage-2 steps make one ``draws`` each."""
    ranges, _, _ = _case(case)
    assert {n for n, _, _ in ranges} == EMITTED[case]
    renders = [(a, b) for n, a, b in ranges if n == "render"]
    for n, a, b in ranges:
        if n.startswith("render."):
            assert any(ra <= a and b <= rb for ra, rb in renders), n
    if case in ("d_step", "g_step"):
        assert [n for n, _, _ in ranges].count("draws") == 1
    if case == "r1_step":
        # R1's gradient of the gradient and the penalty's backward
        assert [n for n, _, _ in ranges].count("backward") == 2


@pytest.mark.parametrize("case", CASES)
def test_step_is_bitwise_the_same_under_the_profiler(case):
    _, (metrics, params), (plain_metrics, plain_params) = _case(case)
    assert set(metrics) == set(plain_metrics)
    for k in metrics:
        assert torch.equal(metrics[k], plain_metrics[k]), k
    assert len(params) == len(plain_params)
    for p, q in zip(params, plain_params):
        assert torch.equal(p, q)
