"""DDIM sampler: a Python loop over the reversed DDIM steps.

The update of the reference (gen_slices ddim.py:162-201, as the JAX package's
``slice3d_tpu/diffusion/ddim.py`` scans it): eps-parameterisation,
eta-scaled stochasticity times ``temperature``, no clipping, and
classifier-free guidance ``eps = e_u + s (e_c - e_u)`` when an unconditional
``eps_fn_uncond`` is given with a scale other than 1 (the slice sampler's
2B-batched guidance lives in its ``eps_fn`` instead).  The per-step
coefficients are float32, computed as the JAX scan computes them.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from .schedule import DDIMParams

__all__ = ["ddim_sample", "guided", "initial_noise"]

EpsFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def initial_noise(shape: Tuple[int, ...], generator: Optional[torch.Generator],
                  device, x_T: Optional[torch.Tensor]) -> torch.Tensor:
    """``x_T`` as fp32 on ``device``, or a draw from ``generator``."""
    if x_T is None:
        return torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
    return x_T.to(device=device, dtype=torch.float32)


def guided(eps_fn: EpsFn, guidance_scale: float, eps_fn_uncond: Optional[EpsFn]) -> EpsFn:
    """``eps_fn`` with classifier-free guidance against ``eps_fn_uncond``
    (two model calls a step) when that is given and the scale is not 1."""
    if eps_fn_uncond is None or guidance_scale == 1.0:
        return eps_fn

    def eps(x, t):
        e_c = eps_fn(x, t)
        e_u = eps_fn_uncond(x, t)
        return e_u + guidance_scale * (e_c - e_u)

    return eps


def ddim_sample(eps_fn: EpsFn, params: DDIMParams, shape: Tuple[int, ...], *,
                generator: Optional[torch.Generator] = None,
                device: Optional[torch.device] = None,
                x_T: Optional[torch.Tensor] = None,
                noises: Optional[Sequence[torch.Tensor]] = None,
                temperature: float = 1.0, guidance_scale: float = 1.0,
                eps_fn_uncond: Optional[EpsFn] = None) -> torch.Tensor:
    """Run the reverse DDIM trajectory; returns the final fp32 latent.

    eps_fn: (x, t_batch) -> predicted noise, conditioning closed over.
    The initial noise ``x_T`` and the per-step noises (``noises[i]`` is used
    at the i-th step in descending time order) are drawn from ``generator``
    unless given; a step with sigma 0 draws none.  ``temperature`` scales
    the injected noise; ``guidance_scale`` / ``eps_fn_uncond`` as
    :func:`guided`.
    """
    x = initial_noise(shape, generator, device, x_T)
    if noises is not None and len(noises) != params.num_steps:
        raise ValueError(f"need {params.num_steps} step noises, got {len(noises)}")
    eps_fn = guided(eps_fn, guidance_scale, eps_fn_uncond)
    b = shape[0]
    one = np.float32(1.0)
    for i, j in enumerate(reversed(range(params.num_steps))):
        a, ap = params.alphas[j], params.alphas_prev[j]
        s1m, sg = params.sqrt_one_minus_alphas[j], params.sigmas[j]
        tb = torch.full((b,), int(params.timesteps[j]), dtype=torch.int64, device=x.device)
        eps = eps_fn(x, tb)
        pred_x0 = (x - float(s1m) * eps) / float(np.sqrt(a))
        x_new = float(np.sqrt(ap)) * pred_x0 + float(np.sqrt(max(one - ap - sg * sg,
                                                                  np.float32(0.0)))) * eps
        if sg != 0:
            noise = noises[i] if noises is not None else torch.randn(
                x.shape, generator=generator, device=x.device, dtype=torch.float32)
            x_new = x_new + float(sg) * noise.to(x) * float(temperature)
        x = x_new
    return x
