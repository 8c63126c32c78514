"""Slice sampling: input views -> 12 generated slice images per object.

The JAX package's ``LDMTrainer.sample_slices``
(``slice3d_tpu/train/train_ldm.py:305-423``): encode, condition, run a
sampler over the latent atlas, decode.  Samplers: ``"ddim"`` (eta-stochastic,
the reference's), ``"dpm"`` (DPM-Solver++(2M)), ``"plms"`` (eta forced to 0)
and ``"ancestral"`` (the full-T DDPM chain).  A guidance scale other than 1
runs classifier-free guidance as ONE 2B-batched UNet call a step on
``cat([uncond, cond])`` (zeroed conditioning unless ``uncond`` is given),
so the attention kernel sees batch 2B.  Two shortcuts, both exact because
the VAE works image by image:

  (a) the reference encodes the whole 13-image stack (12 slices + the input
      view) but the sampling path reads only the input view's latent
      (tile 12), so only the input view is encoded here;
  (b) the reference decodes 13 atlas tiles and drops the 13th (a padding
      tile), so only 12 are decoded here.

Random draws come from an explicit ``torch.Generator`` (posterior noise of
the input view, then ``x_T``, then the sampler's per-step noises), or are
handed in, so a test can give both packages the same numbers.  The sampler
runs on CUDA unless the caller asks for another device, and moves the model
there.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Union

import torch

from .. import resolve_device
from .ancestral import ddpm_sample
from .ddim import ddim_sample
from .dpm import dpm_solver_sample
from .latent import LatentDiffusion
from .plms import plms_sample
from .schedule import DDIMParams

__all__ = ["SAMPLERS", "sample_slices", "sample_atlas", "make_eps_fn", "run_sampler",
           "encode_condition", "atlas_shape"]

SAMPLERS = ("ddim", "dpm", "plms", "ancestral")


def _map_cond(fn, *conds):
    """``fn`` over the leaves (tensors) of conditioning dicts of one
    structure (``c_concat`` and the ``c_fmaps`` dict)."""
    first = conds[0]
    if isinstance(first, dict):
        return {k: _map_cond(fn, *(c[k] for c in conds)) for k in first}
    return fn(*conds)


def make_eps_fn(ldm: LatentDiffusion, cond: Dict, guidance_scale: float = 1.0,
                uncond: Optional[Dict] = None):
    """(x, t) -> predicted noise under ``cond``; with a guidance scale other
    than 1, ``e_u + s (e_c - e_u)`` from one UNet call on the 2B batch
    ``cat([uncond, cond])`` (``uncond`` defaults to zeros of ``cond``'s
    shapes, dtypes and device)."""
    if guidance_scale == 1.0:
        def eps_fn(x, t):
            return ldm.apply_model(x, t, cond)

        return eps_fn
    if uncond is None:
        uncond = _map_cond(torch.zeros_like, cond)
    cond2 = _map_cond(lambda u, c: torch.cat([u.to(c), c]), uncond, cond)

    def eps_fn(x, t):
        out = ldm.apply_model(torch.cat([x, x]), torch.cat([t, t]), cond2)
        e_u, e_c = out.chunk(2)
        return e_u + guidance_scale * (e_c - e_u)

    return eps_fn


def run_sampler(sampler: str, eps_fn, ldm: LatentDiffusion, shape, *, ddim_steps: int,
                eta: float, generator: Optional[torch.Generator], device,
                x_T: Optional[torch.Tensor] = None,
                step_noises: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
    """The final scaled atlas of ``sampler`` (one of ``SAMPLERS``) over
    ``ldm``'s schedule; ``step_noises`` are DDIM's (``ddim_steps``) or the
    ancestral chain's (T); DPM and PLMS draw none."""
    kw = dict(generator=generator, device=device, x_T=x_T)
    if sampler == "ddim":
        return ddim_sample(eps_fn, DDIMParams.create(ldm.schedule, ddim_steps, eta), shape,
                           noises=step_noises, **kw)
    if sampler == "dpm":
        return dpm_solver_sample(eps_fn, DDIMParams.create(ldm.schedule, ddim_steps, eta),
                                 shape, **kw)
    if sampler == "plms":
        return plms_sample(eps_fn, DDIMParams.create(ldm.schedule, ddim_steps, 0.0), shape,
                           **kw)
    if sampler == "ancestral":
        return ddpm_sample(eps_fn, ldm.schedule, shape, noises=step_noises,
                           clip_denoised=False, **kw)[0]
    raise ValueError(f"unknown sampler {sampler!r}: one of {SAMPLERS}")


def encode_condition(ldm: LatentDiffusion, img: torch.Tensor, generator, posterior_noise):
    """The input views' conditioning (only the input view is encoded)."""
    noise = None if posterior_noise is None else posterior_noise.to(img.device)[:, None]
    z_view = ldm.encode_images(img[:, None], noise=noise, generator=generator)
    return ldm.build_cond(z_view, img)


def atlas_shape(ldm: LatentDiffusion, img: torch.Tensor):
    b, h, w, _ = img.shape
    f = ldm.downscale
    return (b, (h // f) * 4, (w // f) * 4, 4)


@torch.no_grad()
def sample_atlas(ldm: LatentDiffusion, img_input: torch.Tensor, *, sampler: str = "ddim",
                 ddim_steps: int = 200, eta: float = 1.0, guidance_scale: float = 1.0,
                 uncond: Optional[Dict] = None, generator: Optional[torch.Generator] = None,
                 posterior_noise: Optional[torch.Tensor] = None,
                 x_T: Optional[torch.Tensor] = None,
                 step_noises: Optional[Sequence[torch.Tensor]] = None,
                 device: Optional[Union[str, torch.device]] = None) -> torch.Tensor:
    """img_input (B, H, W, 3) in [-1, 1] -> the sampled, scaled latent atlas
    (B, 4H/f, 4W/f, 4) fp32 on ``device`` (arguments as :func:`sample_slices`)."""
    device = resolve_device(device)
    ldm.to(device)
    img = img_input.to(device=device, dtype=torch.float32)
    cond = encode_condition(ldm, img, generator, posterior_noise)
    eps_fn = make_eps_fn(ldm, cond, guidance_scale, uncond)
    return run_sampler(sampler, eps_fn, ldm, atlas_shape(ldm, img), ddim_steps=ddim_steps,
                       eta=eta, generator=generator, device=device, x_T=x_T,
                       step_noises=step_noises)


@torch.no_grad()
def sample_slices(ldm: LatentDiffusion, img_input: torch.Tensor, **kwargs) -> torch.Tensor:
    """img_input (B, H, W, 3) in [-1, 1] -> generated slices (B, 12, H, W, 3)
    fp32, on ``device``.

    Keyword arguments: sampler (``"ddim"``, ``"dpm"``, ``"plms"`` (eta 0) or
    ``"ancestral"``), ddim_steps (200; the ancestral chain walks all T),
    eta (1.0), guidance_scale (1.0: off) and uncond (the unconditional
    conditioning, zeros by default), generator (on ``device``), device
    (CUDA unless given; ``ldm`` is moved there), and posterior_noise
    (B, H/f, W/f, 4), x_T (B, 4H/f, 4W/f, 4) and step_noises (DDIM's
    ddim_steps, or the ancestral chain's T, of x_T's shape, descending
    time), which replace the generator's draws where given.
    """
    atlas = sample_atlas(ldm, img_input, **kwargs)
    return ldm.decode_atlas_images(atlas, keep=12).to(torch.float32)
