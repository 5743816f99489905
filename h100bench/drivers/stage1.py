"""Stage-1 training: steps through the program's step
(``train/stage1.py:make_train_step``) on seeded patch batches, float32 with
TF32 off, on the route the configuration names (``models.use_pallas_mlp``:
the fused dense chain). The patch LPIPS term runs on seeded VGG16 weights.
"""

from __future__ import annotations

from typing import Dict

import torch

from h100bench import generate
from h100bench.checks import tf32_off, training_readings
from h100bench.drivers.training import Loop, Record, leaves_of, log_builds
from h100bench.harness import Run, log
from h100bench.reference import steps as ref
from h100bench.trace import span
from h100bench.weights import fill_, generator, lpips_params


class Stage1:
    def __init__(self, run: Run):
        from havatar_tpu_torch.train import stage1
        from havatar_tpu_torch.utils.cfgnode import CfgNode

        self.run, dev = run, run.device
        self.cfg, self.tr = run.cell.config, run.cell.traffic
        tf32_off()          # the configuration's float32
        cfg = CfgNode(self.cfg["config"])
        with torch.device(dev):
            renderer = stage1.build_renderer(cfg)
        fill_(renderer, run.seed, "renderer")
        log("renderer built and filled")
        state = stage1.init_state(cfg, self.cfg["assumed"]["num_frames"],
                                  dev, renderer)
        self.state = state
        self.train_step = stage1.make_train_step(
            state, cfg, lpips_params(dev, run.seed))
        rec = Record(leaves_of(state.renderer, state.latent_codes))
        log("optimizer, step and record made")
        for i in range(self.tr["checked_steps"]):
            m = self.step(i)
            log(f"checked step {i} done")
            if i == 0:
                log_builds()
            rec.first_grad("nerf", state.optimizer)
            rec.losses.append({"loss": float(m["loss"])})
        self.program = rec.finish()
        self.loop = Loop(run, self.step, self.tr["checked_steps"],
                         self.tr["trace_steps"])

    def step(self, i: int):
        run = self.run
        batch = generate.stage1_batch(run.seed, i, self.tr, self.cfg,
                                      run.device)
        rng = generator(run.device, run.seed, f"rng{i}")
        with span("step"):
            return self.train_step(batch, rng)

    def window(self, seconds: float, tracer=None) -> None:
        self.loop.window(seconds, tracer)

    def close(self) -> None:
        del self.state, self.train_step, self.loop

    def check(self) -> Dict[str, float]:
        return training_readings(self.program, reference_run(self.run),
                                 self.tr["compared_losses"])


def reference_run(run: Run, half_batch: bool = False) -> Dict:
    """The reference's readings of the checked steps; ``half_batch`` leaves
    out the second half of every batch (a fault)."""
    cfg, tr, dev = run.cell.config, run.cell.traffic, run.device
    c = cfg["config"]
    with torch.device(dev):
        renderer = ref.build_renderer(c)
        codes = torch.zeros(cfg["assumed"]["num_frames"],
                            c["experiment"]["latent_code_dim"])
    fill_(renderer, run.seed, "renderer")
    st = ref.Stage1(c, renderer, codes, lpips_params(dev, run.seed))
    rec = Record(leaves_of(st.renderer, st.latent_codes))
    for i in range(tr["checked_steps"]):
        batch = generate.stage1_batch(run.seed, i, tr, cfg, dev)
        if half_batch:
            batch = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
        rec.losses.append(st.step(batch, generator(dev, run.seed,
                                                   f"rng{i}")))
        rec.first_grad("nerf", st.opt)
    return rec.finish()


def build(run: Run) -> Stage1:
    return Stage1(run)
