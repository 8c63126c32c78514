"""PatchGAN discriminator and the adversarial losses of the VAE finetune.

The JAX package's ``slice3d_tpu/models/discriminator.py`` (reference
taming ``NLayerDiscriminator`` and gen_slices/ldm/modules/losses/
contperceptual.py:7-111): 4x4 convolutions, stride 2 but for the last body
conv and the output conv, LeakyReLU 0.2, BatchNorm (flax's: momentum 0.9,
biased variance; ``layers.BatchNorm2d``) after every body conv but the
first.  The layers sit in one ``main`` Sequential at taming's indices
(``main.0`` conv, ``main.2 / .3`` conv and BatchNorm, ..., ``main.{3n+2}``
the output conv), so a reference autoencoder checkpoint's
``loss.discriminator.main.*`` entries load as they are.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .layers import BatchNorm2d, Conv2d

__all__ = ["NLayerDiscriminator", "patchgan_logits_size", "hinge_d_loss", "generator_loss",
           "adaptive_disc_weight"]


class NLayerDiscriminator(nn.Module):
    """70x70 PatchGAN over NHWC images in [-1, 1] -> NHWC logits (N, s, s, 1).

    ``train`` (default: ``self.training``) normalises on batch statistics and
    moves the running ones; otherwise the running statistics normalise.
    ``dtype`` is the compute dtype (None: the input's); parameters stay fp32
    and are cast at use, the BatchNorm statistics are fp32."""

    def __init__(self, ndf: int = 64, n_layers: int = 3, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.n_layers = n_layers
        self.dtype = dtype
        layers = [Conv2d(3, ndf, 4, stride=2, padding=1), nn.LeakyReLU(0.2)]
        ch = ndf
        for i in range(1, n_layers + 1):
            cout = ndf * min(2 ** i, 8)
            layers += [Conv2d(ch, cout, 4, stride=2 if i < n_layers else 1, padding=1,
                              bias=False), BatchNorm2d(cout), nn.LeakyReLU(0.2)]
            ch = cout
        layers.append(Conv2d(ch, 1, 4, stride=1, padding=1))
        self.main = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor, train: Optional[bool] = None) -> torch.Tensor:
        h = x.permute(0, 3, 1, 2).to(self.dtype or x.dtype)
        for layer in self.main:
            h = layer(h, train) if isinstance(layer, BatchNorm2d) else layer(h)
        return h.permute(0, 2, 3, 1)


def patchgan_logits_size(img_size: int, n_layers: int = 3) -> int:
    """Side of ``NLayerDiscriminator``'s logits for a square input; below 1
    the logits are empty (their mean is NaN), so the depth must shrink."""
    s = (img_size - 2) // 2 + 1
    for i in range(1, n_layers + 1):
        s = (s - 2) // (2 if i < n_layers else 1) + 1
    return s - 1


def hinge_d_loss(logits_real: torch.Tensor, logits_fake: torch.Tensor) -> torch.Tensor:
    return 0.5 * (torch.mean(F.relu(1.0 - logits_real)) + torch.mean(F.relu(1.0 + logits_fake)))


def generator_loss(logits_fake: torch.Tensor) -> torch.Tensor:
    return -torch.mean(logits_fake)


def adaptive_disc_weight(nll_grad_norm: torch.Tensor, g_grad_norm: torch.Tensor,
                         disc_factor: float = 1.0) -> torch.Tensor:
    """||grad nll|| / ||grad g|| at the decoder's last layer, clipped to
    [0, 1e4], times ``disc_factor``, detached as the reference's
    ``calculate_adaptive_weight`` detaches it (the JAX package
    differentiates through it)."""
    w = nll_grad_norm / (g_grad_norm + 1e-4)
    return (torch.clamp(w, 0.0, 1e4) * disc_factor).detach()
