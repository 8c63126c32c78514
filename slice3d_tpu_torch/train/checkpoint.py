"""Checkpoints of the port's trainers: ``torch.save`` files with the
reference's naming.

The JAX package's ``slice3d_tpu/train/checkpoint.py`` writes flax msgpack
files or orbax directories; the port writes one ``torch.save`` file of a
dictionary of tensors, numbers and optimizer state, through a temporary
name so a reader never sees half a file.  ``latest_checkpoint`` picks the
newest file by modification time (``--resume``), and ``TopKCheckpointer``
keeps the k best by a monitored metric beside ``last.ckpt``, as the
reference's ModelCheckpoint does (gen_slices/main.py:576-597).  The
optimizer payloads gather moments sharded over the ``model`` axis
(``parallel.shard_params_fsdp``) before a write and hand each process its
part on a read, so sharded and unsharded runs read and write one format.
"""

from __future__ import annotations

import glob
import os
import zipfile
from typing import Any, Dict, Optional, Sequence, Union

import torch

from ..parallel.sharding import full_tensor, shard_like

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_checkpoint", "is_torch_file",
           "adam_payload", "load_adam_payload", "optimizer_payload", "load_optimizer_payload",
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


def adam_payload(optimizer: torch.optim.Optimizer, model: torch.nn.Module) -> Dict[str, Any]:
    """Adam's state by ``model``'s parameter names: ``count`` (the updates
    taken) and ``exp_avg`` / ``exp_avg_sq``, the layout that the JAX
    trainers' optax moments map into (``convert.py``).  Sharded moments are
    gathered (every process of the model group calls it), so a sharded run
    writes the tensors an unsharded one does."""
    adam: Dict[str, Any] = {"count": 0, "exp_avg": {}, "exp_avg_sq": {}}
    for name, p in model.named_parameters():
        st = optimizer.state.get(p)
        if st:
            adam["count"] = int(st["step"])
            adam["exp_avg"][name] = full_tensor(st["exp_avg"])
            adam["exp_avg_sq"][name] = full_tensor(st["exp_avg_sq"])
    return adam


def load_adam_payload(optimizer: torch.optim.Optimizer, model: torch.nn.Module,
                      adam: Dict[str, Any]) -> None:
    """The inverse of :func:`adam_payload`, in place: each named parameter of
    ``model`` that ``optimizer`` holds takes its moments (its part of them
    where it is sharded) and the step."""
    held = {p for group in optimizer.param_groups for p in group["params"]}
    for name, p in model.named_parameters():
        if p in held and name in adam["exp_avg"]:
            optimizer.state[p] = {"step": torch.tensor(float(adam["count"])),
                                  "exp_avg": shard_like(p, adam["exp_avg"][name]),
                                  "exp_avg_sq": shard_like(p, adam["exp_avg_sq"][name])}


def optimizer_payload(optimizer: torch.optim.Optimizer,
                      params: Sequence[torch.Tensor]) -> Dict[str, Any]:
    """``optimizer.state_dict()`` as an optimizer over ``params`` in one group
    gives it (the state by index into ``params``, the first group's
    hyperparameters), with sharded state gathered (every process of the
    model group calls it): an unsharded optimizer's own ``state_dict``, and
    the same file from a sharded run."""
    state = {}
    for i, p in enumerate(params):
        st = optimizer.state.get(p)
        if st:
            state[i] = {k: full_tensor(v) if isinstance(v, torch.Tensor) else v
                        for k, v in st.items()}
    group = {k: v for k, v in optimizer.param_groups[0].items() if k != "params"}
    group["params"] = list(range(len(params)))
    return {"state": state, "param_groups": [group]}


def load_optimizer_payload(optimizer: torch.optim.Optimizer, params: Sequence[torch.Tensor],
                           payload: Dict[str, Any]) -> None:
    """The inverse of :func:`optimizer_payload`, in place: every group takes
    the saved hyperparameters and each of ``params`` its state, its part of
    it where it is sharded (a copy of the step)."""
    saved = {k: v for k, v in payload["param_groups"][0].items() if k != "params"}
    for group in optimizer.param_groups:
        group.update(saved)
    for i, p in enumerate(params):
        st = payload["state"].get(i)
        if st is not None:
            optimizer.state[p] = {k: (v.clone() if k == "step" else shard_like(p, v))
                                  if isinstance(v, torch.Tensor) else v for k, v in st.items()}


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
