"""Stage-2 training: D + G iterations through the program's steps
(``train/stage2.py:make_steps``), as the stage-2 CLI runs them without
``--fast-step``: a D step, an R1 step every ``gan.d_reg_every`` iterations
from 0, a G step. Float32 with TF32 off; the route the configuration names
(``models.use_pallas_mlp_quad``: the fused quad op, the CLI's
``--fused-quad``). The window starts at an iteration index divisible by
``d_reg_every``, right after the checked iterations, so it holds whole R1
periods (plus at most one).
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


class Stage2:
    def __init__(self, run: Run):
        from havatar_tpu_torch.train import stage2
        from havatar_tpu_torch.utils.cfgnode import CfgNode

        self.run, dev = run, run.device
        self.cfg, self.tr = run.cell.config, run.cell.traffic
        tf32_off()          # the configuration's float32
        cfg = CfgNode(self.cfg["config"])
        self.every = cfg.gan.d_reg_every
        with torch.device(dev):
            models = stage2.build_models(cfg)
        for m, tag in zip(models, ("renderer", "generator", "discriminator")):
            fill_(m, run.seed, tag)
        log("models built and filled")
        state = stage2.init_state(cfg, self.cfg["assumed"]["num_frames"],
                                  dev, models)
        self.state = state
        d_step, r1_step, g_step, _ = stage2.make_steps(
            state, cfg, lpips_params(dev, run.seed))
        self.steps = (d_step, r1_step, g_step)

        rec = Record(leaves_of(state.renderer, state.latent_codes,
                               generator=state.generator,
                               discriminator=state.discriminator))
        log("optimizers, steps and record made")
        for i in range(self.tr["checked_iterations"]):
            rec.losses.append(self.iteration(i, rec))
            log(f"checked iteration {i} done")
            if i == 0:
                log_builds()
        self.program = rec.finish()
        # the window goes on from the next multiple of d_reg_every; the
        # indices between are skipped, not run: a batch and its draws
        # depend on the index alone, and R1 on ``i % every``
        first = self.every * max(1, -(-self.tr["checked_iterations"]
                                      // self.every))
        self.loop = Loop(run, self.iteration, first,
                         self.tr["trace_iterations"])

    def iteration(self, i: int, rec: Record = None):
        run, (d_step, r1_step, g_step) = self.run, self.steps
        batch = generate.stage2_batch(run.seed, i, self.tr, self.cfg,
                                      run.device)
        rng = generator(run.device, run.seed, f"rng{i}")
        sp = run.spans
        with span("d_step"):
            sp and sp.start("d_step")
            d = d_step(batch, rng)
            sp and sp.stop("d_step")
        if rec is not None:
            rec.first_grad("discriminator", self.state.d_opt)
            log(f"iteration {i}: D step done")
        r1 = None
        if i % self.every == 0:
            with span("r1_step"):
                sp and sp.start("r1_step")
                r1 = r1_step(batch)
                sp and sp.stop("r1_step")
            if rec is not None:
                log(f"iteration {i}: R1 step done "
                    f"({float(r1['r1']):.4g})")
        with span("g_step"):
            sp and sp.start("g_step")
            g = g_step(batch, rng)
            sp and sp.stop("g_step")
        if rec is None:
            return None
        rec.first_grad("nerf", self.state.nerf_opt)
        rec.first_grad("generator", self.state.g_opt)
        losses = {"d": float(d["d"]), **{k: float(g[k]) for k in
                                        ("nerf_loss", "g", "hr_l1",
                                         "percep")}}
        if r1 is not None:
            losses["r1"] = float(r1["r1"])
        return losses

    def window(self, seconds: float, tracer=None) -> None:
        self.loop.window(seconds, tracer)

    def close(self) -> None:
        del self.state, self.steps, self.loop

    def check(self) -> Dict[str, float]:
        return training_readings(self.program, reference_run(self.run),
                                 self.tr["compared_losses"])


def reference_run(run: Run, half_batch: bool = False) -> Dict:
    """The reference's readings of the checked iterations; ``half_batch``
    leaves out the second half of every batch (a fault)."""
    cfg, tr, dev = run.cell.config, run.cell.traffic, run.device
    c = cfg["config"]
    with torch.device(dev):
        models = (ref.build_renderer(c), ref.build_generator(c),
                  ref.build_discriminator(c))
    for m, tag in zip(models, ("renderer", "generator", "discriminator")):
        fill_(m, run.seed, tag)
    with torch.device(dev):
        codes = torch.zeros(cfg["assumed"]["num_frames"],
                            c["experiment"]["latent_code_dim"])
    st = ref.Stage2(c, *models, codes, lpips_params(dev, run.seed))
    rec = Record(leaves_of(st.renderer, st.latent_codes,
                           generator=st.gen, discriminator=st.disc))
    every = c["gan"]["d_reg_every"]
    for i in range(tr["checked_iterations"]):
        batch = generate.stage2_batch(run.seed, i, tr, cfg, dev)
        if half_batch:
            batch = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
        rng = generator(dev, run.seed, f"rng{i}")
        losses = st.d_step(batch, rng)
        rec.first_grad("discriminator", st.d_opt)
        if i % every == 0:
            losses.update(st.r1_step(batch))
        losses.update(st.g_step(batch, rng))
        rec.first_grad("nerf", st.nerf_opt)
        rec.first_grad("generator", st.g_opt)
        rec.losses.append(losses)
    return rec.finish()


def build(run: Run) -> Stage2:
    return Stage2(run)
