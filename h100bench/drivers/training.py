"""What both training drivers share: the checked first steps and the
window.

Set-up builds one training step with its models and optimizers and drives
it from the seed through its first ``checked`` steps, through the window's
own call and feed on batches that all differ, recording each step's losses,
each optimizer's first gradient (per leaf, from Adam's first moment) and
the parameters' change over those steps; it then warms up to the window's
first step. The window runs whole steps until ``--seconds`` have passed and
ends on a synchronise. After the window the program's state is freed and the
plain reference follows the same first steps from the same weights, batches
and draws (``checks.training_readings``).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List

import torch

from h100bench.checks import adam_grad_norms, change_norms
from h100bench.harness import Run, Spans, log
from h100bench.trace import Tracer


def log_builds() -> None:
    """A set-up line naming the kernel sources that this run compiled
    (none where the checkout's ``build/`` already held them)."""
    from havatar_tpu_torch.ops import cuda_build
    log(f"kernels compiled in this run: "
        f"{sorted(cuda_build.build_logs) or 'none'}")


def named_leaves(groups: Dict[str, List]) -> Dict[str, torch.Tensor]:
    """{"<group>.<name>": tensor} of ``groups``' (name, tensor) lists."""
    return {f"{g}.{n}": p for g, items in groups.items() for n, p in items}


def leaves_of(renderer, latent_codes, **modules) -> Dict[str, List]:
    groups = {"nerf": list(renderer.named_parameters())
              + [("latent_codes", latent_codes)]}
    for g, m in modules.items():
        groups[g] = list(m.named_parameters())
    return groups


class Record:
    """Losses, first gradients and change of the checked steps."""

    def __init__(self, groups: Dict[str, List]):
        self.named = named_leaves(groups)
        self.names = {id(p): n for n, p in self.named.items()}
        self.before = {n: p.detach().clone() for n, p in self.named.items()}
        self.losses: List[Dict[str, float]] = []
        self.grad: Dict[str, Dict[str, float]] = {}

    def first_grad(self, group: str, opt: torch.optim.Optimizer) -> None:
        if group not in self.grad:
            self.grad[group] = adam_grad_norms(opt, self.names)

    def finish(self) -> Dict:
        out = {"losses": self.losses, "grad": self.grad,
               "change": change_norms(self.named, self.before)}
        del self.before
        return out


class Loop:
    """The window over whole steps of ``step(i)``; with ``trace`` the
    first ``trace_steps`` of them are profiled and the spans of the step's
    parts (``Spans``) are recorded."""

    def __init__(self, run: Run, step: Callable[[int], None], first: int,
                 trace_steps: int):
        self.run, self.step, self.first = run, step, first
        self.trace_steps = trace_steps

    def window(self, seconds: float, tracer: Tracer = None) -> None:
        run = self.run
        if run.trace:
            run.spans = Spans(run.device)
        n_trace = self.trace_steps if tracer else 0
        sync = (torch.cuda.synchronize if run.device.type == "cuda"
                else (lambda: None))
        sync()
        start = time.perf_counter()
        i = 0
        while True:
            if i == 0 and n_trace:
                tracer.start()
            self.step(self.first + i)
            i += 1
            if n_trace and i == n_trace:
                tracer.stop(n_trace)
            if time.perf_counter() - start >= seconds and i >= n_trace:
                break
        sync()
        run.window_s = time.perf_counter() - start
        run.units = i
