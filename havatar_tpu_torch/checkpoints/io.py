"""Training checkpoints: ``torch.save`` files in the reference's layouts.

Counterpart of ``havatar_tpu/checkpoints/io.py`` (an orbax manager there).
A stage-1 checkpoint is the reference trainer's dict::

    {"iter": int, "optimizer_state_dict": ..., "loss": float, "psnr": float,
     "trainer_state_dict": {"model_coarse.*",
                            "headpose_skin_net.canonical_Wvolume.*",
                            "latent_codes"}}

so ``havatar_tpu.checkpoints.convert.convert_stage1_checkpoint`` reads it.
``iter`` is the number of finished steps: a resumed run starts there.

``CheckpointManager`` has the JAX manager's surface: ``save(step, tree,
force)`` writes ``ckpt_<step>.pt`` when ``step`` is a multiple of
``save_interval_steps`` or ``force`` is set, under a temporary name that is
renamed once complete, and keeps the newest ``max_to_keep`` files;
``restore`` loads one step or the latest; ``latest_step``; ``wait`` (writes
are synchronous here, so it returns at once).
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Optional

import torch

_NAME = re.compile(r"ckpt_(\d+)\.pt")


def stage1_checkpoint(renderer: torch.nn.Module, latent_codes: torch.Tensor,
                      optimizer: torch.optim.Optimizer, step: int,
                      loss: float = float("nan"),
                      psnr: float = float("nan")) -> Dict[str, Any]:
    """The dict to save after ``step`` finished steps."""
    trainer = {k: v.detach().cpu().clone()
               for k, v in renderer.state_dict().items()}
    trainer["latent_codes"] = latent_codes.detach().cpu().clone()
    return {"iter": int(step),
            "optimizer_state_dict": optimizer.state_dict(),
            "loss": float(loss), "psnr": float(psnr),
            "trainer_state_dict": trainer}


def load_checkpoint(path: str) -> Optional[Dict[str, Any]]:
    """A checkpoint file, or the latest one of a manager's directory (None
    if the directory holds none)."""
    if os.path.isdir(path):
        return CheckpointManager(path).restore()
    return torch.load(path, map_location="cpu", weights_only=False)


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 5,
                 save_interval_steps: int = 1):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.save_interval_steps = max(1, int(save_interval_steps))

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step:08d}.pt")

    def all_steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in
                      map(_NAME.fullmatch, os.listdir(self.directory)) if m)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, tree: Any, force: bool = False) -> bool:
        """Write ``tree`` as step ``step``. Returns whether it was written:
        not when the step is off the interval (and not forced), and not a
        second time for a step already on disk (unless forced)."""
        step = int(step)
        path = self._path(step)
        if not force and (step % self.save_interval_steps
                          or os.path.exists(path)):
            return False
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(tree, tmp)
        os.replace(tmp, path)
        for old in self.all_steps()[:-self.max_to_keep or None]:
            os.remove(self._path(old))
        return True

    def restore(self, step: Optional[int] = None) -> Any:
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        return torch.load(self._path(step), map_location="cpu",
                          weights_only=False)

    def wait(self) -> None:
        """Writes are finished when ``save`` returns."""
