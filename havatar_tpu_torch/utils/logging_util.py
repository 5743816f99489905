"""Metrics and run records: a scalar/image writer and code snapshots.

The port's own copy of ``havatar_tpu/utils/logging_util.py``.
"""

from __future__ import annotations

import datetime
import json
import os
import tarfile

import numpy as np


class MetricsWriter:
    """TensorBoard when ``tensorboardX`` is installed, else a
    ``metrics.jsonl`` of scalars in the log directory (images are then
    dropped)."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        self.logdir = logdir
        self._tb = None
        self._jsonl = None
        try:
            from tensorboardX import SummaryWriter

            self._tb = SummaryWriter(logdir)
        except ImportError:
            self._jsonl = open(os.path.join(logdir, "metrics.jsonl"), "a")

    def scalar(self, tag: str, value, step: int) -> None:
        value = float(value)
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)
        else:
            self._jsonl.write(json.dumps({"tag": tag, "value": value,
                                          "step": step}) + "\n")
            self._jsonl.flush()

    def image(self, tag: str, img_hwc: np.ndarray, step: int) -> None:
        if self._tb is not None:
            self._tb.add_image(tag, np.asarray(img_hwc), step,
                               dataformats="HWC")

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
        else:
            self._jsonl.close()


def create_code_snapshot(src_dir: str, out_path: str) -> None:
    """Tar the package's source up beside the run's logs."""
    def _filter(ti: tarfile.TarInfo):
        if any(part in ti.name for part in
               (".git", "__pycache__", ".pyc", "logs", "renders")):
            return None
        return ti

    with tarfile.open(out_path, "w:gz") as tar:
        tar.add(src_dir, arcname=os.path.basename(src_dir), filter=_filter)


def timestamp() -> str:
    return datetime.datetime.now().strftime("%Y_%m_%d_%H_%M_%S")
