"""LR multiplier schedules for LDM training.

A numpy copy of ``slice3d_tpu/train/lr_schedules.py``, itself a rebuild of
the reference schedulers (``gen_slices/ldm/lr_scheduler.py:4-98``):
``f(step) -> multiplier`` functions applied on top of the base LR, computed
in float32 as the JAX package computes them.

* ``warmup_cosine`` - LambdaWarmUpCosineScheduler: linear warm-up
  lr_start -> lr_max, then cosine decay to lr_min over max_decay_steps.
* ``warmup_cosine2`` - LambdaWarmUpCosineScheduler2: list-configured
  repeated cycles of the same shape.
* ``warmup_linear`` - LambdaLinearScheduler: per cycle, linear warm-up then
  the reference's linear decay ``f_min + (f_max-f_min)*(cycle_len-n)/cycle_len``
  (the decay ramp spans the whole cycle, not the cycle minus the warm-up:
  reference ``lr_scheduler.py:88-97``).

``from_scheduler_config`` resolves the reference's ``scheduler_config``
block (target + params) into one of these.
"""

from __future__ import annotations

from typing import Callable, Sequence, Union

import numpy as np

__all__ = ["warmup_cosine", "warmup_cosine2", "warmup_linear", "from_scheduler_config"]

_Lists = Union[float, int, Sequence[float], Sequence[int]]
_F32 = np.float32


def warmup_cosine(warm_up_steps: int, lr_min: float, lr_max: float,
                  lr_start: float, max_decay_steps: int) -> Callable[[int], float]:
    """LambdaWarmUpCosineScheduler (reference lr_scheduler.py:4-30)."""

    def schedule(step):
        step = _F32(step)
        warm = _F32(lr_start) + _F32(lr_max - lr_start) * step / _F32(max(warm_up_steps, 1))
        t = np.clip((step - _F32(warm_up_steps))
                    / _F32(max(max_decay_steps - warm_up_steps, 1)), _F32(0), _F32(1))
        cos = _F32(lr_min) + _F32(0.5 * (lr_max - lr_min)) * (_F32(1) + np.cos(t * _F32(np.pi)))
        return float(warm if step < warm_up_steps else cos)

    return schedule


def _as_arrays(*vals: _Lists):
    arrs = [np.atleast_1d(np.asarray(v, np.float64)) for v in vals]
    n = max(a.shape[0] for a in arrs)
    return [np.broadcast_to(a, (n,)).astype(_F32) for a in arrs]


def _cycle_split(cycle_lengths: np.ndarray):
    """step n -> (cycle index, offset into the cycle)."""
    cum = np.concatenate([[0.0], np.cumsum(cycle_lengths.astype(np.float64))]).astype(_F32)

    def locate(step):
        step = _F32(step)
        # reference find_in_interval: the first cycle whose cumulative end >= n
        cyc = int(np.clip(np.searchsorted(cum[1:], step, side="left"), 0,
                          len(cycle_lengths) - 1))
        return cyc, step - cum[cyc]

    return locate


def _cycles(warm_up_steps, f_min, f_max, f_start, cycle_lengths, after_warmup):
    wu, fmin, fmax, fstart, cl = _as_arrays(warm_up_steps, f_min, f_max, f_start,
                                            cycle_lengths)
    locate = _cycle_split(cl)

    def schedule(step):
        c, n = locate(step)
        if n < wu[c]:
            return float((fmax[c] - fstart[c]) / max(wu[c], _F32(1)) * n + fstart[c])
        return float(after_warmup(n, wu[c], fmin[c], fmax[c], cl[c]))

    return schedule


def warmup_cosine2(warm_up_steps: _Lists, f_min: _Lists, f_max: _Lists,
                   f_start: _Lists, cycle_lengths: _Lists) -> Callable[[int], float]:
    """LambdaWarmUpCosineScheduler2 (reference lr_scheduler.py:36-78)."""

    def cosine(n, wu, fmin, fmax, cl):
        t = np.clip((n - wu) / max(cl - wu, _F32(1)), _F32(0), _F32(1))
        return fmin + _F32(0.5) * (fmax - fmin) * (_F32(1) + np.cos(t * _F32(np.pi)))

    return _cycles(warm_up_steps, f_min, f_max, f_start, cycle_lengths, cosine)


def warmup_linear(warm_up_steps: _Lists, f_min: _Lists, f_max: _Lists,
                  f_start: _Lists, cycle_lengths: _Lists) -> Callable[[int], float]:
    """LambdaLinearScheduler (reference lr_scheduler.py:81-98)."""

    def linear(n, wu, fmin, fmax, cl):
        return fmin + (fmax - fmin) * (cl - n) / cl

    return _cycles(warm_up_steps, f_min, f_max, f_start, cycle_lengths, linear)


_TARGETS = {
    "ldm.lr_scheduler.LambdaWarmUpCosineScheduler": warmup_cosine,
    "ldm.lr_scheduler.LambdaWarmUpCosineScheduler2": warmup_cosine2,
    "ldm.lr_scheduler.LambdaLinearScheduler": warmup_linear,
    "warmup_cosine": warmup_cosine,
    "warmup_cosine2": warmup_cosine2,
    "warmup_linear": warmup_linear,
}


def from_scheduler_config(cfg):
    """Resolve a reference-style ``scheduler_config`` block (ddpm.py:1431-1441),
    e.g. ``{"target": "ldm.lr_scheduler.LambdaLinearScheduler", "params":
    {"warm_up_steps": [100], "f_min": [1.0], ...}}``; None stays None."""
    if cfg is None:
        return None
    target = cfg["target"]
    if target not in _TARGETS:
        raise KeyError(f"unknown scheduler target {target!r}")
    params = dict(cfg.get("params") or {})
    params.pop("verbosity_interval", None)
    return _TARGETS[target](**params)
