"""The numbers that decide ``correct``: what the timed path produced, held
against the plain reference (``reference/``) on the same inputs and
weights, after the window.

``loss_gap`` is the worst relative gap of the losses that the traffic
file's ``compared_losses`` names for each checked step; ``grad_gap`` the
worst leaf's gap between the norms of the first gradient as its optimizer
got it (worked out from Adam's first moment after one step), over the
larger of the reference's norm of that leaf and of its optimizer's median
leaf; ``grad_median_gap`` the median over an optimizer's leaves of the
same gap (the largest over the optimizers), steady where one leaf's
gradient is summed by atomics in an order that changes from run to run;
``change_gap`` the worst leaf's gap for the parameters' change after the
checked steps. Leaves whose reference gradient is under a thousandth of
their optimizer's median leaf (zero but for rounding, as a bias before an
instance norm) move under Adam by rounding alone and are left out of the
change. A cell compares the readings that its limits file names.

``tf32`` computes the reference in the precision below the
configuration's float32: the control.
"""

from __future__ import annotations

import contextlib
import statistics
from typing import Dict, List

import torch


def tf32_off() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@contextlib.contextmanager
def tf32():
    """TF32 on for matmuls and cuDNN convolutions (the control of a
    float32 cell)."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def adam_grad_norms(opt: torch.optim.Optimizer,
                    names: Dict[int, str]) -> Dict[str, float]:
    """Per leaf, the norm of the gradient of ``opt``'s first step, from its
    first moment: exp_avg = (1 - beta1) g."""
    out = {}
    for group in opt.param_groups:
        b1 = group["betas"][0]
        for p in group["params"]:
            st = opt.state.get(p, {})
            if "exp_avg" in st:
                out[names[id(p)]] = float(st["exp_avg"].norm()) / (1 - b1)
    return out


def change_norms(named: Dict[str, torch.Tensor],
                 before: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {n: float((p.detach() - before[n]).norm())
            for n, p in named.items()}


def loss_gaps_by_step(prog: Dict, want: Dict) -> List[Dict[str, float]]:
    """Each checked step's relative loss gaps, by loss (a look at where
    ``loss_gap`` comes from)."""
    return [{k: abs(p[k] - w[k]) / max(abs(w[k]), 1e-12) for k in w}
            for p, w in zip(prog["losses"], want["losses"])]


def training_readings(prog: Dict, want: Dict,
                      compared: List[List[str]]) -> Dict[str, float]:
    """``prog`` and ``want`` (the reference) each hold ``losses`` (a list of
    {name: value} a step), ``grad`` ({group: {leaf: norm}}) and ``change``
    ({leaf: norm}); ``compared`` names the losses compared at each step."""
    loss_gap = max(abs(p[k] - w[k]) / max(abs(w[k]), 1e-12)
                   for p, w, keys in zip(prog["losses"], want["losses"],
                                         compared) for k in keys)
    grad_gap = grad_median_gap = change_gap = 0.0
    for group, wg in want["grad"].items():
        pg = prog["grad"][group]
        med = statistics.median(wg.values())
        gaps = [abs(pg.get(leaf, 0.0) - w) / max(w, med)
                for leaf, w in wg.items()]
        grad_gap = max(grad_gap, *gaps)
        grad_median_gap = max(grad_median_gap, statistics.median(gaps))
        moved = [n for n, w in wg.items() if w >= 1e-3 * med]
        med_c = statistics.median(want["change"][n] for n in moved)
        for n in moved:
            w = want["change"][n]
            change_gap = max(change_gap,
                             abs(prog["change"][n] - w) / max(w, med_c))
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "grad_median_gap": grad_median_gap, "change_gap": change_gap}
