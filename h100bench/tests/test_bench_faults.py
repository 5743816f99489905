"""A run whose timed path is broken underneath comes out as not correct:
each fault a cell can have, planted in the program while the rest of the
run (set-up, window, check against the reference, the cell's own limits)
is the benchmark's, on the CPU at tiny size. The sound run of each cell
comes out correct. One chip: no exchange between chips to leave out."""

from __future__ import annotations

import pytest

from h100bench import run as bench_run
from h100bench.tests import tinycell


def correct(name: str, seed: int = 31) -> bool:
    r, readings = tinycell.run(name, seed=seed)
    return bench_run.result(r, readings, 1)["correct"]


def half(batch):
    return {k: v[: v.shape[0] // 2] for k, v in batch.items()}


@pytest.mark.parametrize("name", ["hd512.train_dg", "base512.train_s1"])
def test_sound_run_is_correct(name):
    assert correct(name)


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_stage2_faults(monkeypatch, fault):
    from havatar_tpu_torch.train import stage2
    if fault == "unchanged":
        init = stage2.init_state

        def frozen_state(*a, **k):
            st = init(*a, **k)
            for opt in (st.nerf_opt, st.g_opt, st.d_opt):
                opt.step = lambda *a, **k: None
            return st
        monkeypatch.setattr(stage2, "init_state", frozen_state)
    else:
        make = stage2.make_steps

        def halved(*a, **k):
            d, r1, g, dg = make(*a, **k)
            return (lambda b, rng: d(half(b), rng), lambda b: r1(half(b)),
                    lambda b, rng: g(half(b), rng), dg)
        monkeypatch.setattr(stage2, "make_steps", halved)
    assert not correct("hd512.train_dg")


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_stage1_faults(monkeypatch, fault):
    from havatar_tpu_torch.train import stage1
    if fault == "unchanged":
        init = stage1.init_state

        def frozen_state(*a, **k):
            st = init(*a, **k)
            st.optimizer.step = lambda *a, **k: None
            return st
        monkeypatch.setattr(stage1, "init_state", frozen_state)
    else:
        make = stage1.make_train_step

        def halved(*a, **k):
            step = make(*a, **k)
            return lambda b, rng: step(half(b), rng)
        monkeypatch.setattr(stage1, "make_train_step", halved)
    assert not correct("base512.train_s1")
