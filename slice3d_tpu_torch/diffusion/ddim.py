"""DDIM sampler: a Python loop over the reversed DDIM steps.

The update of the reference (gen_slices ddim.py:162-201, as the JAX package's
``slice3d_tpu/diffusion/ddim.py`` scans it): eps-parameterisation,
eta-scaled stochasticity, no clipping.  The per-step coefficients are
float32, computed as the JAX scan computes them.  Only plain conditional
sampling (guidance scale 1) is ported.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from .schedule import DDIMParams

__all__ = ["ddim_sample"]


def ddim_sample(eps_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
                params: DDIMParams, shape: Tuple[int, ...], *,
                generator: Optional[torch.Generator] = None,
                device: Optional[torch.device] = None,
                x_T: Optional[torch.Tensor] = None,
                noises: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
    """Run the reverse DDIM trajectory; returns the final fp32 latent.

    eps_fn: (x, t_batch) -> predicted noise, conditioning closed over.
    The initial noise ``x_T`` and the per-step noises (``noises[i]`` is used
    at the i-th step in descending time order) are drawn from ``generator``
    unless given; a step with sigma 0 draws none.
    """
    if x_T is None:
        x = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
    else:
        x = x_T.to(device=device, dtype=torch.float32)
    if noises is not None and len(noises) != params.num_steps:
        raise ValueError(f"need {params.num_steps} step noises, got {len(noises)}")
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
            x_new = x_new + float(sg) * noise.to(x)
        x = x_new
    return x
