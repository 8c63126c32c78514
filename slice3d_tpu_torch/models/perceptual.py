"""VGG19 perceptual loss (the JAX package's ``slice3d_tpu/models/perceptual.py``,
reference reg_slices/src/vgg_perceptual_loss.py).

L1 distance between the five VGG19 taps of prediction and target, weighted
[1/2.6, 1/4.8, 1/3.7, 1/5.6, 10/1.5], on ImageNet-renormalised images that
arrive in [-1, 1].  The VGG19 is frozen: the caller keeps it out of the
optimizer, and the target's pass runs without a graph.
"""

from __future__ import annotations

from typing import Optional

import torch

from .vgg import VGG19Features, imagenet_renorm

__all__ = ["PERCEPTUAL_WEIGHTS", "perceptual_loss"]

PERCEPTUAL_WEIGHTS = (1.0 / 2.6, 1.0 / 4.8, 1.0 / 3.7, 1.0 / 5.6, 10.0 / 1.5)


def perceptual_loss(vgg: VGG19Features, pred: torch.Tensor, target: torch.Tensor, *,
                    dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """pred, target (N, H, W, 3) in [-1, 1] -> the fp32 scalar loss; the
    trunk computes in ``dtype`` (None: the images')."""

    def taps(x):
        x = imagenet_renorm(x).permute(0, 3, 1, 2)
        return vgg(x.to(dtype or x.dtype).contiguous())

    xs = taps(pred)
    with torch.no_grad():
        ys = taps(target)
    loss = torch.zeros((), dtype=torch.float32, device=pred.device)
    for w, x, y in zip(PERCEPTUAL_WEIGHTS, xs, ys):
        loss = loss + w * torch.mean(torch.abs(x.float() - y.float()))
    return loss
