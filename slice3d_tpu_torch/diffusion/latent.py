"""LatentDiffusion: the Slice3D slice-generation model and its training loss.

The reference ``LatentDiffusion`` at the Slice3D operating point: a frozen
kl-f8 VAE encodes images to latents, the 12 slice latents tile into a 4x4
atlas (4 x 64 x 64 at 128 px), and an fmap-conditioned UNet denoises the
atlas with the input view's latent tiled alongside, channel-wise.  Parameter
names are the reference's: ``first_stage_model.*``,
``model.diffusion_model.*``, ``cond_stage_model.*`` and the ``scale_factor``
buffer (a reference checkpoint also carries schedule buffers, ``logvar``
and ``model_ema.*``, which inference does not read: load it with
``strict=False``).  ``p_losses`` is the eps-prediction loss of training
(``slice3d_tpu/diffusion/latent.py::p_losses``).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from ..models.cond_encoder import CondImageEncoder
from ..models.ldm_unet import LDMUNet
from ..models.random_init import random_init_
from ..models.vae import AutoencoderKL, DiagonalGaussian
from ..ops.atlas import tile_slices_to_atlas, untile_atlas
from .schedule import DiffusionSchedule

__all__ = ["LatentDiffusion", "derived_inject", "init_latent_diffusion", "p_losses"]


def derived_inject(unet_channels: int, unet_mult: Sequence[int], unet_nres: int
                   ) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """Injection blocks and conditioning widths from the UNet config: after
    the input conv, the first res block of levels 1 .. L-2 and the
    downsample into the last level (0/4/7/10/12 for 2 res blocks, 5 levels);
    widths follow model_channels * channel_mult."""
    n_levels = len(unet_mult)
    per = unet_nres + 1
    blocks = [0] + [1 + level * per for level in range(1, n_levels - 1)]
    blocks.append((n_levels - 1) * per)
    widths = [unet_channels * unet_mult[level] for level in range(n_levels - 1)]
    widths.append(unet_channels * unet_mult[n_levels - 2])
    return tuple(blocks), tuple(widths)


class _DiffusionWrapper(nn.Module):
    """Holder that gives the UNet the reference's ``model.diffusion_model``
    prefix."""

    def __init__(self, unet: LDMUNet):
        super().__init__()
        self.diffusion_model = unet


class LatentDiffusion(nn.Module):
    """``dtype`` is the networks' compute dtype; latents, the schedule and
    the sampler stay fp32.  ``fused=False`` keeps the UNet's attention on
    the plain path."""

    def __init__(self, *, timesteps: int = 1000, linear_start: float = 0.0015,
                 linear_end: float = 0.0155, vae_ch: int = 128,
                 vae_mult: Sequence[int] = (1, 2, 4, 4), vae_nres: int = 2,
                 unet_channels: int = 192, unet_mult: Sequence[int] = (1, 2, 2, 4, 4),
                 unet_nres: int = 2, unet_attention_ds: Sequence[int] = (1, 2, 4, 8),
                 unet_inject_blocks: Optional[Sequence[int]] = None,
                 cond_widths: Optional[Sequence[int]] = None, latent_size: int = 16,
                 fused: bool = True, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.timesteps = timesteps
        self.linear_start = linear_start
        self.linear_end = linear_end
        inject, widths = derived_inject(unet_channels, unet_mult, unet_nres)
        inject = tuple(unet_inject_blocks) if unet_inject_blocks is not None else inject
        widths = tuple(cond_widths) if cond_widths is not None else widths
        self.first_stage_model = AutoencoderKL(ch=vae_ch, ch_mult=vae_mult,
                                               num_res_blocks=vae_nres, dtype=dtype)
        self.model = _DiffusionWrapper(LDMUNet(
            model_channels=unet_channels, channel_mult=unet_mult, num_res_blocks=unet_nres,
            attention_ds=unet_attention_ds, fmap_inject_blocks=inject,
            fused=fused, dtype=dtype))
        self.cond_stage_model = CondImageEncoder(widths, latent_size, dtype=dtype)
        self.register_buffer("scale_factor", torch.tensor(1.0))

    @property
    def downscale(self) -> int:
        return self.first_stage_model.downscale

    @property
    def schedule(self) -> DiffusionSchedule:
        return DiffusionSchedule.create(self.timesteps, "linear", self.linear_start,
                                        self.linear_end)

    # -- first stage -----------------------------------------------------------

    def encode_images(self, images: torch.Tensor, *, noise: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, K, H, W, 3) -> (B, K, H/f, W/f, 4) fp32 latents (unscaled),
        sampled from the posterior with ``noise`` (B, K, h, w, 4) or draws
        from ``generator``."""
        b, k, h, w, c = images.shape
        f = self.downscale
        moments = self.first_stage_model.encode_moments(images.reshape(b * k, h, w, c))
        post = DiagonalGaussian(moments.to(torch.float32))
        z = post.sample(None if noise is None else noise.reshape(post.mean.shape), generator)
        return z.reshape(b, k, h // f, w // f, -1)

    def decode_tiles(self, z: torch.Tensor) -> torch.Tensor:
        """(B, K, h, w, 4) unscaled latents -> (B, K, f h, f w, 3) images."""
        b, k = z.shape[:2]
        imgs = self.first_stage_model.decode(z.reshape((b * k,) + z.shape[2:]))
        return imgs.reshape((b, k) + imgs.shape[1:])

    def decode_atlas_images(self, atlas_scaled: torch.Tensor, keep: int = 13) -> torch.Tensor:
        """(B, 4h, 4w, 4) scaled atlas -> the first ``keep`` tiles decoded."""
        return self.decode_tiles(untile_atlas(atlas_scaled / self.scale_factor, keep=keep))

    # -- conditioning and denoiser --------------------------------------------

    def build_cond(self, z13: torch.Tensor, img_input: torch.Tensor,
                   train: Optional[bool] = None) -> Dict:
        """z13 (B, K, h, w, 4) unscaled latents whose LAST tile is the input
        view's (tile 12 of the reference's 13); img_input (B, H, W, 3).
        ``train=True`` runs the conditioner's BatchNorms on batch statistics
        and updates their running statistics (the reference trains the
        conditioner in train mode); None follows the modules' mode."""
        fmaps = self.cond_stage_model(img_input, train)
        c_concat = (z13[:, -1] * self.scale_factor).repeat(1, 4, 4, 1)
        return {"c_concat": c_concat, "c_fmaps": fmaps}

    def make_atlas(self, z13: torch.Tensor) -> torch.Tensor:
        """(B, 13, h, w, 4) unscaled latents -> the scaled (B, 4h, 4w, 4)
        atlas of the 12 slices: the diffusion target."""
        return tile_slices_to_atlas(z13[:, :12] * self.scale_factor)

    def apply_model(self, x: torch.Tensor, t: torch.Tensor, cond: Dict) -> torch.Tensor:
        """x (B, 4h, 4w, 4) noisy atlas, t (B,) -> predicted noise, fp32."""
        xc = torch.cat([x, cond["c_concat"].to(x.dtype)], dim=-1)
        return self.model.diffusion_model(xc, t, cond["c_fmaps"])


def p_losses(ldm: LatentDiffusion, schedule: DiffusionSchedule, x_start: torch.Tensor,
             cond: Dict, *, logvar: Optional[torch.Tensor] = None, loss_type: str = "l1",
             t: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None, l_simple_weight: float = 1.0,
             original_elbo_weight: float = 0.0) -> Tuple[torch.Tensor, Dict]:
    """Eps-prediction loss with the logvar weighting (reference
    ddpm.py:1116-1149): x_start (B, 4h, 4w, 4) the clean atlas.

    ``t`` (B,) uniform in [0, T) and ``noise`` (x_start's shape, Gaussian) are
    drawn from ``generator`` (t first) unless given.  Returns the loss and
    the logs ``loss``, ``loss_simple`` and ``loss_vlb`` (0-d tensors)."""
    b, dev = x_start.shape[0], x_start.device
    if t is None:
        t = torch.randint(0, schedule.num_timesteps, (b,), generator=generator, device=dev)
    if noise is None:
        noise = torch.randn(x_start.shape, generator=generator, device=dev,
                            dtype=x_start.dtype)
    t = t.to(dev, torch.long)

    def table(a):
        return torch.from_numpy(a).to(dev)[t]

    x_noisy = (table(schedule.sqrt_alphas_cumprod)[:, None, None, None] * x_start
               + table(schedule.sqrt_one_minus_alphas_cumprod)[:, None, None, None] * noise)
    model_out = ldm.apply_model(x_noisy, t, cond)
    err = (model_out - noise).abs() if loss_type == "l1" else (model_out - noise) ** 2
    loss_simple = err.mean((1, 2, 3))
    logs = {"loss_simple": loss_simple.mean()}
    if logvar is not None:
        lv = logvar[t]
        loss = loss_simple / torch.exp(lv) + lv
    else:
        loss = loss_simple
    loss = l_simple_weight * loss.mean()
    lvlb = (table(schedule.lvlb_weights) * loss_simple).mean()
    logs["loss_vlb"] = lvlb
    loss = loss + original_elbo_weight * lvlb
    logs["loss"] = loss
    return loss, logs


def init_latent_diffusion(seed: int = 0, generator: Optional[torch.Generator] = None,
                          **config) -> LatentDiffusion:
    """A ``LatentDiffusion(**config)`` with every weight and statistic drawn
    from ``generator`` (seeded with ``seed`` when not given), the layers the
    reference zero-initialises included (see ``random_init_``); in eval mode
    on the CPU.  The defaults are the 128 px operating point (VAE ch 128,
    mult (1, 2, 4, 4); UNet 192, (1, 2, 2, 4, 4), attention ds 1/2/4/8, 8
    heads; latent 16; VGG16-BN conditioner)."""
    g = generator if generator is not None else torch.Generator().manual_seed(seed)
    return random_init_(LatentDiffusion(**config), g)
