"""Ancestral DDPM sampling and progressive denoising: a loop over every step.

The JAX package's ``slice3d_tpu/diffusion/ancestral.py`` (reference
gen_slices ddpm.py:1151-1238 ``p_mean_variance`` / ``p_sample`` /
``progressive_denoising`` and :1270-1336 ``p_sample_loop``):
eps-parameterisation, the posterior mean with the clipped log-variance, no
noise at t = 0, optional [-1, 1] clipping of the x0 estimate and a
``temperature`` on the injected noise.  Intermediates follow the
reference's logging rule (``t % log_every_t == 0 or t == T - 1``).
Coefficients are float32, as the JAX scan reads them from the schedule.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .ddim import EpsFn, initial_noise
from .schedule import DiffusionSchedule

__all__ = ["ddpm_sample", "_log_slots"]


def _log_slots(timesteps: int, log_every_t: int) -> Tuple[np.ndarray, int]:
    """Per-step intermediate slot in descending t order, and the number of
    logged steps: a step logs when ``t % log_every_t == 0 or t == timesteps
    - 1`` (ddpm.py:1312, 1264); a step that does not gets slot ``n_log``."""
    ts = np.arange(timesteps - 1, -1, -1)
    is_log = (ts % log_every_t == 0) | (ts == timesteps - 1)
    slots = np.where(is_log, np.cumsum(is_log) - 1, int(is_log.sum()))
    return slots.astype(np.int32), int(is_log.sum())


def ddpm_sample(eps_fn: EpsFn, schedule: DiffusionSchedule, shape: Tuple[int, ...], *,
                generator: Optional[torch.Generator] = None,
                device: Optional[torch.device] = None,
                x_T: Optional[torch.Tensor] = None,
                noises: Optional[Sequence[torch.Tensor]] = None,
                timesteps: Optional[int] = None, clip_denoised: bool = False,
                temperature: float = 1.0, log_every_t: Optional[int] = None,
                record: str = "x") -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Run the reverse ancestral trajectory over the lowest ``timesteps``
    steps (all T by default).  Returns (x_0, intermediates or None).

    ``x_T`` and the per-step noises (``noises[i]`` at the i-th step in
    descending t order, one for each walked step; the t = 0 one is not
    used) are drawn from ``generator`` unless given; no noise is drawn at
    t = 0.  With ``log_every_t`` the intermediates are stacked:
    ``record="x"`` gives (n_log + 1, *shape), row 0 the initial noise (as
    ``p_sample_loop``); ``record="pred_x0"`` gives the running x0 estimate,
    (n_log, *shape) (as ``progressive_denoising``).
    """
    if record not in ("x", "pred_x0"):
        raise ValueError(record)
    t_total = schedule.num_timesteps
    t_run = t_total if timesteps is None else min(timesteps, t_total)
    if noises is not None and len(noises) != t_run:
        raise ValueError(f"need {t_run} step noises, got {len(noises)}")
    x = initial_noise(shape, generator, device, x_T)
    slots, n_log = _log_slots(t_run, log_every_t) if log_every_t else (None, 0)
    rows = [x] if (log_every_t and record == "x") else []
    sr_ac, srm1_ac = schedule.sqrt_recip_alphas_cumprod, schedule.sqrt_recipm1_alphas_cumprod
    coef1, coef2 = schedule.posterior_mean_coef1, schedule.posterior_mean_coef2
    log_var = schedule.posterior_log_variance_clipped
    b = shape[0]
    for i, t in enumerate(range(t_run - 1, -1, -1)):
        eps = eps_fn(x, torch.full((b,), t, dtype=torch.int64, device=x.device))
        # predict_start_from_noise (ddpm.py:217-221)
        x0 = float(sr_ac[t]) * x - float(srm1_ac[t]) * eps
        if clip_denoised:
            x0 = x0.clamp(-1.0, 1.0)
        # q_posterior mean and clipped log-variance (ddpm.py:223-230)
        x_next = float(coef1[t]) * x0 + float(coef2[t]) * x
        if t > 0:
            noise = noises[i] if noises is not None else torch.randn(
                x.shape, generator=generator, device=x.device, dtype=torch.float32)
            std = np.exp(np.float32(0.5) * log_var[t])
            x_next = x_next + float(std) * (noise.to(x) * float(temperature))
        if slots is not None and slots[i] < n_log:
            rows.append(x_next if record == "x" else x0)
        x = x_next
    return x, (torch.stack(rows) if log_every_t else None)
