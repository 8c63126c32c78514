"""Slice sampling: input views -> 12 generated slice images per object.

The JAX package's ``LDMTrainer.sample_slices`` with the ``ddim`` sampler and
guidance scale 1 (``slice3d_tpu/train/train_ldm.py:305-406``; classifier-free
guidance is not ported): encode, condition, run DDIM over the latent atlas,
decode.  Two shortcuts, both exact because the VAE works image by image:

  (a) the reference encodes the whole 13-image stack (12 slices + the input
      view) but the sampling path reads only the input view's latent
      (tile 12), so only the input view is encoded here;
  (b) the reference decodes 13 atlas tiles and drops the 13th (a padding
      tile), so only 12 are decoded here.

Random draws come from an explicit ``torch.Generator`` (posterior noise of
the input view, then ``x_T``, then one noise per DDIM step), or are handed
in, so a test can give both packages the same numbers.  The sampler runs on
CUDA unless the caller asks for another device, and moves the model there.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

from .. import resolve_device
from .ddim import ddim_sample
from .latent import LatentDiffusion
from .schedule import DDIMParams

__all__ = ["sample_slices", "sample_atlas", "make_eps_fn"]


def make_eps_fn(ldm: LatentDiffusion, cond):
    """(x, t) -> predicted noise under ``cond`` (guidance scale 1: the
    classifier-free guidance branch is not ported)."""

    def eps_fn(x, t):
        return ldm.apply_model(x, t, cond)

    return eps_fn


@torch.no_grad()
def sample_atlas(ldm: LatentDiffusion, img_input: torch.Tensor, *, ddim_steps: int = 200,
                 eta: float = 1.0, generator: Optional[torch.Generator] = None,
                 posterior_noise: Optional[torch.Tensor] = None,
                 x_T: Optional[torch.Tensor] = None,
                 step_noises: Optional[Sequence[torch.Tensor]] = None,
                 device: Optional[Union[str, torch.device]] = None) -> torch.Tensor:
    """img_input (B, H, W, 3) in [-1, 1] -> the sampled, scaled latent atlas
    (B, 4H/f, 4W/f, 4) fp32 on ``device`` (arguments as :func:`sample_slices`)."""
    device = resolve_device(device)
    ldm.to(device)
    img = img_input.to(device=device, dtype=torch.float32)
    b, h, w, _ = img.shape
    noise = None if posterior_noise is None else posterior_noise.to(device)[:, None]
    z_view = ldm.encode_images(img[:, None], noise=noise, generator=generator)
    cond = ldm.build_cond(z_view, img)
    f = ldm.downscale
    shape = (b, (h // f) * 4, (w // f) * 4, 4)
    params = DDIMParams.create(ldm.schedule, ddim_steps, eta)
    return ddim_sample(make_eps_fn(ldm, cond), params, shape,
                       generator=generator, device=device, x_T=x_T, noises=step_noises)


@torch.no_grad()
def sample_slices(ldm: LatentDiffusion, img_input: torch.Tensor, **kwargs) -> torch.Tensor:
    """img_input (B, H, W, 3) in [-1, 1] -> generated slices (B, 12, H, W, 3)
    fp32, on ``device``.

    Keyword arguments: ddim_steps (200), eta (1.0), generator (on ``device``),
    device (CUDA unless given; ``ldm`` is moved there), and posterior_noise
    (B, H/f, W/f, 4), x_T (B, 4H/f, 4W/f, 4) and step_noises (ddim_steps of
    x_T's shape, descending time), which replace the generator's draws where
    given.
    """
    atlas = sample_atlas(ldm, img_input, **kwargs)
    return ldm.decode_atlas_images(atlas, keep=12).to(torch.float32)
