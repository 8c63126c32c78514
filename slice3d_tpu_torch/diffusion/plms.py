"""PLMS (pseudo linear multistep) sampler: a Python loop over the DDIM steps.

The JAX package's ``slice3d_tpu/diffusion/plms.py`` (reference gen_slices
plms.py:173-236): eps-parameterisation with eta 0 (a nonzero eta is
refused), step 0 a pseudo improved-Euler corrector with two model
evaluations at schedule row 0 (the second at the next step's time,
``steps[min(1, n - 1)]``), later steps Adams-Bashforth of order 2, 3 and 4
over the raw eps history as it fills.  A run of n steps makes n + 1 model
evaluations.  Coefficients are float32, as the JAX scan computes them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .ddim import EpsFn, guided, initial_noise
from .schedule import DDIMParams

__all__ = ["plms_sample"]


def plms_sample(eps_fn: EpsFn, params: DDIMParams, shape: Tuple[int, ...], *,
                generator: Optional[torch.Generator] = None,
                device: Optional[torch.device] = None,
                x_T: Optional[torch.Tensor] = None, guidance_scale: float = 1.0,
                eps_fn_uncond: Optional[EpsFn] = None) -> torch.Tensor:
    """Run the reverse PLMS trajectory; returns the final fp32 latent.

    ``params`` must be built with eta 0 (``ValueError`` otherwise);
    ``x_T`` is drawn from ``generator`` unless given (the trajectory draws
    nothing else); guidance as :func:`slice3d_tpu_torch.diffusion.ddim.guided`.
    """
    if float(np.max(np.abs(params.sigmas))) != 0.0:
        raise ValueError("ddim_eta must be 0 for PLMS (plms.py:25-26)")
    x = initial_noise(shape, generator, device, x_T)
    model = guided(eps_fn, guidance_scale, eps_fn_uncond)
    n, b = params.num_steps, shape[0]
    # descending time order (the reference's time_range = flip(ddim_timesteps))
    steps = params.timesteps[::-1]
    a_t, a_prev = params.alphas[::-1], params.alphas_prev[::-1]
    s1m = params.sqrt_one_minus_alphas[::-1]
    one, zero = np.float32(1.0), np.float32(0.0)

    def model_eps(x, t_step):
        return model(x, torch.full((b,), int(t_step), dtype=torch.int64, device=x.device))

    def update(x, eps, i):
        # get_x_prev_and_pred_x0 with sigma 0 (plms.py:201-216), at row i
        pred_x0 = (x - float(s1m[i]) * eps) / float(np.sqrt(a_t[i]))
        dir_xt = float(np.sqrt(np.maximum(one - a_prev[i], zero))) * eps
        return float(np.sqrt(a_prev[i])) * pred_x0 + dir_xt

    # step 0: pseudo improved Euler, both updates at row 0 (plms.py:222-226)
    e0 = model_eps(x, steps[0])
    x_eul = update(x, e0, 0)
    e0_next = model_eps(x_eul, steps[min(1, n - 1)])
    x = update(x, (e0 + e0_next) / 2.0, 0)
    hist = [e0]  # newest first
    for i in range(1, n):
        e_t = model_eps(x, steps[i])
        if i == 1:
            e_prime = (3.0 * e_t - hist[0]) / 2.0
        elif i == 2:
            e_prime = (23.0 * e_t - 16.0 * hist[0] + 5.0 * hist[1]) / 12.0
        else:
            e_prime = (55.0 * e_t - 59.0 * hist[0] + 37.0 * hist[1] - 9.0 * hist[2]) / 24.0
        x = update(x, e_prime, i)
        hist = [e_t] + hist[:2]
    return x
