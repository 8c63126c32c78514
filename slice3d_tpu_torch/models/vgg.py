"""VGG16-BN trunk with the reference's five pre-BatchNorm taps.

The reference cuts torchvision's ``vgg16_bn().features`` into the blocks
``[:4] [4:11] [11:21] [21:31] [31:41] [41:44]``; slicing a ``Sequential``
keeps the original child indices, so the blocks' parameter names are
``down1.0``, ``down1.3``, ``down2.4``, ... as in reference checkpoints.  Each
block ends on a conv, so the taps are pre-BN; the last block (BN, ReLU,
pool of tap 5) is only carried for its parameters.

The block names are a constructor argument: SliceNet's slice U-Net calls
them ``down1 .. down5_``; GTSlice's ``img_encoder`` and the LDM
conditioner's ``cond_stage_model`` call them ``conv1_2, conv2_2, conv3_3,
conv4_3, conv5_3, conv_last``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
from torch import nn

from .layers import BatchNorm2d, Conv2d

__all__ = ["VGG16BNBackbone", "vgg16_bn_features", "imagenet_renorm",
           "SLICENET_BLOCKS", "REF_ENCODER_BLOCKS"]

SLICENET_BLOCKS = ("down1", "down2", "down3", "down4", "down5", "down5_")
REF_ENCODER_BLOCKS = ("conv1_2", "conv2_2", "conv3_3", "conv4_3", "conv5_3", "conv_last")
_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


def imagenet_renorm(x: torch.Tensor) -> torch.Tensor:
    """Map (..., 3) images from [-1, 1] to ImageNet-normalised values."""
    mean = torch.tensor(_IMAGENET_MEAN, dtype=x.dtype, device=x.device)
    std = torch.tensor(_IMAGENET_STD, dtype=x.dtype, device=x.device)
    return ((x + 1.0) * 0.5 - mean) / std

_VGG16_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
              512, 512, 512, "M", 512, 512, 512, "M"]
_CUTS = (0, 4, 11, 21, 31, 41, 44)


def vgg16_bn_features() -> nn.Sequential:
    """torchvision's vgg16_bn ``features`` stack (config D with BN)."""
    layers: List[nn.Module] = []
    cin = 3
    for v in _VGG16_CFG:
        if v == "M":
            layers.append(nn.MaxPool2d(2, 2))
        else:
            layers += [Conv2d(cin, v, 3, padding=1), BatchNorm2d(v), nn.ReLU()]
            cin = v
    return nn.Sequential(*layers)


class VGG16BNBackbone(nn.Module):
    """Six blocks named by ``block_names``; NCHW in, 5 taps out (the first
    five blocks): 64@H, 128@H/2, 256@H/4, 512@H/8, 512@H/16 (pre-BN).
    ``with_final`` also runs the sixth block (BN, ReLU, 2x2 max pool of the
    last tap) and returns ``(taps, final 512@H/32)``."""

    def __init__(self, block_names: Sequence[str] = SLICENET_BLOCKS, with_final: bool = False):
        super().__init__()
        feats = vgg16_bn_features()
        self.block_names = tuple(block_names)
        self.with_final = with_final
        for name, a, b in zip(self.block_names, _CUTS[:-1], _CUTS[1:]):
            setattr(self, name, feats[a:b])

    def forward(self, x: torch.Tensor, train: Optional[bool] = None):
        """``train`` runs the BatchNorms on batch statistics and updates their
        running statistics (True) or on the running statistics (False); None
        follows each BatchNorm's ``training`` flag."""
        taps: List[torch.Tensor] = []
        for name in self.block_names[:5 + self.with_final]:
            for layer in getattr(self, name):
                x = layer(x, train) if isinstance(layer, BatchNorm2d) else layer(x)
            taps.append(x)
        return (taps[:5], taps[5]) if self.with_final else taps
