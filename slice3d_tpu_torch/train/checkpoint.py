"""Checkpoints of the port's trainers: ``torch.save`` files with the
reference's naming.

The JAX package's ``slice3d_tpu/train/checkpoint.py`` writes flax msgpack
files or orbax directories; the port writes one ``torch.save`` file of a
dictionary of tensors, numbers and optimizer state, through a temporary
name so a reader never sees half a file.  ``latest_checkpoint`` picks the
newest file by modification time (``--resume``), and ``TopKCheckpointer``
keeps the k best by a monitored metric beside ``last.ckpt``, as the
reference's ModelCheckpoint does (gen_slices/main.py:576-597).
"""

from __future__ import annotations

import glob
import os
import zipfile
from typing import Any, Dict, Optional, Union

import torch

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_checkpoint", "is_torch_file",
           "TopKCheckpointer"]


def save_checkpoint(path: str, state: Dict[str, Any]) -> str:
    """Write ``state`` to ``path`` (directories made as needed); returns it."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)
    return path


def restore_checkpoint(path: str, map_location: Union[str, torch.device, None] = "cpu"
                       ) -> Dict[str, Any]:
    """Read a file written by :func:`save_checkpoint` (tensors, numbers and
    containers only: ``weights_only``)."""
    return torch.load(path, map_location=map_location, weights_only=True)


def is_torch_file(path: str) -> bool:
    """torch.save's zip format (or its legacy pickle), as opposed to the JAX
    package's msgpack files."""
    if zipfile.is_zipfile(path):
        return True
    with open(path, "rb") as f:
        return f.read(2) in (b"\x80\x02", b"\x80\x04")


def latest_checkpoint(ckpt_dir: str, pattern: str = "*.ckpt") -> Optional[str]:
    """The newest file in ``ckpt_dir`` matching ``pattern``, or None."""
    files = glob.glob(os.path.join(ckpt_dir, pattern))
    return max(files, key=os.path.getmtime) if files else None


class TopKCheckpointer:
    """Keep the k best checkpoints by a monitored metric.

    Filenames carry the step and the metric (``step=000012-val_loss=0.12345
    .ckpt``), so ``ls`` shows training health.  A new instance seeds its list
    from the files already in ``ckpt_dir``, so a resumed run keeps pruning
    against the previous run's best.
    """

    def __init__(self, ckpt_dir: str, monitor: str = "val/loss_simple_ema", k: int = 3,
                 mode: str = "min"):
        if mode not in ("min", "max"):
            raise ValueError(f"mode must be 'min' or 'max', got {mode!r}")
        self.ckpt_dir = ckpt_dir
        self.monitor = monitor
        self.k = k
        self.mode = mode
        self.best: list = []  # [(score, path)], best first
        tag = self._tag
        for path in glob.glob(os.path.join(ckpt_dir, f"step=*-{tag}=*.ckpt")):
            try:
                value = float(path.rsplit(f"{tag}=", 1)[1][:-len(".ckpt")])
            except (IndexError, ValueError):
                continue
            self.best.append((self._score(value), path))
        self.best.sort(key=lambda item: item[0])

    @property
    def _tag(self) -> str:
        return self.monitor.replace("/", "_")

    def _score(self, value: float) -> float:
        return value if self.mode == "min" else -value

    def update(self, value: float, step: int, state: Dict[str, Any]) -> Optional[str]:
        """Save ``state`` if ``value`` ranks in the top k and drop the file
        that falls out; returns the new path, or None."""
        score = self._score(value)
        if len(self.best) >= self.k and score >= self.best[-1][0]:
            return None
        path = os.path.join(self.ckpt_dir, f"step={step:06d}-{self._tag}={value:.5f}.ckpt")
        save_checkpoint(path, state)
        self.best.append((score, path))
        self.best.sort(key=lambda item: item[0])
        while len(self.best) > self.k:
            _, worst = self.best.pop()
            try:
                os.remove(worst)
            except OSError:
                pass
        return path
