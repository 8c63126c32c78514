"""LDM conditioning encoder: input view -> multi-scale UNet injection maps.

The reference ``ImageEncoderVGG16BN``: VGG16-BN taps of the [-1, 1] input
view (ImageNet-renormalised), 1x1-projected to the UNet's level widths
(192/384/384/768/768 at the operating point), nearest-resized to 16/8/4/2/1
px and tiled 4x4 to match the latent atlas.  Parameter names are the
reference's (``conv1_2 .. conv_last`` VGG blocks, ``trans1_2 .. trans5_3``),
the ones ``torch_import.cond_image_encoder`` reads.  The conditioner is
trained with the UNet, its BatchNorms on batch statistics (``train=True``).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch import nn

from ..ops.resize import resize_nearest
from .layers import Conv2d
from .vgg import REF_ENCODER_BLOCKS, VGG16BNBackbone, imagenet_renorm

__all__ = ["CondImageEncoder", "TRANS_NAMES"]

TRANS_NAMES = ("trans1_2", "trans2_2", "trans3_3", "trans4_3", "trans5_3")
_TAP_WIDTHS = (64, 128, 256, 512, 512)


class CondImageEncoder(VGG16BNBackbone):
    """``widths``: the UNet level widths the maps are projected to (one map
    per width, at most five); ``latent_size``: the latent tile size."""

    fsdp_unit = True  # its parameters are read within its forward alone: sharded, one gather

    def __init__(self, widths: Sequence[int] = (192, 384, 384, 768, 768),
                 latent_size: int = 16, dtype: Optional[torch.dtype] = None):
        super().__init__(REF_ENCODER_BLOCKS)
        self.widths = tuple(widths)
        self.latent_size = latent_size
        self.dtype = dtype
        for name, cin, cout in zip(TRANS_NAMES, _TAP_WIDTHS, self.widths):
            setattr(self, name, Conv2d(cin, cout, 1))

    def forward(self, img: torch.Tensor, train: Optional[bool] = None
                ) -> Dict[str, torch.Tensor]:
        """img (B, H, W, 3) in [-1, 1] -> {'f1', ...} (B, 4s, 4s, width) with
        s = max(latent_size >> i, 1).  ``train``: the BatchNorms' mode, as
        :meth:`VGG16BNBackbone.forward` (the JAX ``CondImageEncoder``'s
        ``train`` argument)."""
        x = imagenet_renorm(img).permute(0, 3, 1, 2)
        taps = super().forward(x.to(self.dtype or x.dtype).contiguous(), train)
        out = {}
        for i, (tap, name) in enumerate(zip(taps, TRANS_NAMES[:len(self.widths)])):
            size = max(self.latent_size >> i, 1)
            f = getattr(self, name)(tap).permute(0, 2, 3, 1)
            out[f"f{i + 1}"] = resize_nearest(f, (size, size)).repeat(1, 4, 4, 1)
        return out
