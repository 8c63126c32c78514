"""DPM-Solver++(2M): a deterministic second-order sampler in log-SNR.

The JAX package's ``slice3d_tpu/diffusion/dpm.py`` (Lu et al. 2022, the
data-prediction multistep form) over ``DDIMParams``' nodes: each step goes
from ``alphas[j]`` to ``alphas_prev[j]`` with ``lam = log(ac) - log1p(-ac)``
halved, ``h`` the step in ``lam``; the first step is first order, later ones
use ``r = h_prev / h`` and ``D = (1 + 1/2r) x0 - (1/2r) x0_prev``, and the
update is ``(sigma_t / sigma_c) x - alpha_t expm1(-h) D``.  It discretises
the same probability-flow ODE as DDIM with eta 0.  Coefficients are float32,
as the JAX scan computes them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .ddim import EpsFn, initial_noise
from .schedule import DDIMParams

__all__ = ["dpm_solver_sample"]


def _lam(ac: np.float32) -> np.float32:
    return np.float32(0.5) * (np.log(ac) - np.log1p(-ac))


def dpm_solver_sample(eps_fn: EpsFn, params: DDIMParams, shape: Tuple[int, ...], *,
                      generator: Optional[torch.Generator] = None,
                      device: Optional[torch.device] = None,
                      x_T: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Run the reverse DPM-Solver++(2M) trajectory; returns the final fp32
    latent.  ``params``' sigmas are not read; ``x_T`` is drawn from
    ``generator`` unless given (nothing else is drawn)."""
    x = initial_noise(shape, generator, device, x_T)
    b = shape[0]
    one, two = np.float32(1.0), np.float32(2.0)
    steps = params.timesteps[::-1]
    ac_t = np.asarray(params.alphas, np.float32)[::-1]
    ac_s = np.asarray(params.alphas_prev, np.float32)[::-1]
    prev_x0, prev_h = None, np.float32(1.0)
    for t_step, a_cur, a_tgt in zip(steps, ac_t, ac_s):
        alpha_c, sigma_c = np.sqrt(a_cur), np.sqrt(one - a_cur)
        alpha_t, sigma_t = np.sqrt(a_tgt), np.sqrt(one - a_tgt)
        eps = eps_fn(x, torch.full((b,), int(t_step), dtype=torch.int64, device=x.device))
        x0 = (x - float(sigma_c) * eps) / float(alpha_c)
        h = _lam(a_tgt) - _lam(a_cur)  # > 0: the target is less noisy
        if prev_x0 is None:
            d = x0
        else:
            half_r = one / (two * (prev_h / h))
            d = float(one + half_r) * x0 - float(half_r) * prev_x0
        x = float(sigma_t / sigma_c) * x - float(alpha_t * np.expm1(-h)) * d
        prev_x0, prev_h = x0, h
    return x
