"""Exponential moving average of parameters (reference ldm/modules/ema.py).

The JAX package's ``slice3d_tpu/models/ema.py``: effective decay
``min(decay, (1 + step) / (10 + step))``, so early steps track the weights
closely.  The average is a dictionary of fp32 tensors keyed by parameter
name, updated in place; where a parameter is sharded over the ``model``
axis (``parallel.shard_params_fsdp``) its average is a shard of the same
placement, and the update, elementwise, runs on the local parts.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch.distributed.tensor import DTensor

__all__ = ["ema_decay", "ema_update"]


def ema_decay(step: int, decay: float = 0.9999) -> float:
    """The warm-up decay at ``step``, rounded to fp32 as the JAX package
    computes it."""
    return float(np.minimum(np.float32(decay),
                            (np.float32(1.0) + np.float32(step))
                            / (np.float32(10.0) + np.float32(step))))


@torch.no_grad()
def ema_update(ema: Dict[str, torch.Tensor], params: Mapping[str, torch.Tensor],
               step: int, decay: float = 0.9999) -> None:
    """In place: ``ema[name] = ema[name] d + params[name] (1 - d)`` with
    ``d = ema_decay(step, decay)``, for every name of ``ema``."""
    d = ema_decay(step, decay)
    one_minus = float(np.float32(1.0) - np.float32(d))
    names = list(ema)
    local = lambda t: t.to_local() if isinstance(t, DTensor) else t  # noqa: E731
    averages = [local(ema[n]) for n in names]
    # one multi-tensor launch per op rather than two launches per tensor
    torch._foreach_mul_(averages, d)
    torch._foreach_add_(averages, [local(params[n].detach()).to(ema[n].dtype) for n in names],
                        alpha=one_minus)
