"""VGG16-BN trunk with the reference's five pre-BatchNorm taps.

The reference cuts torchvision's ``vgg16_bn().features`` into the blocks
``[:4] [4:11] [11:21] [21:31] [31:41] [41:44]``; slicing a ``Sequential``
keeps the original child indices, so the blocks' parameter names are
``down1.0``, ``down1.3``, ``down2.4``, ... as in reference checkpoints.  Each
block ends on a conv, so the taps are pre-BN; the last block (BN, ReLU,
pool of tap 5) is only carried for its parameters.
"""

from __future__ import annotations

from typing import List

import torch
from torch import nn

from .layers import BatchNorm2d, Conv2d

__all__ = ["VGG16BNBackbone", "vgg16_bn_features"]

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
    """Blocks ``down1`` .. ``down5`` (+ ``down5_``); NCHW in, 5 taps out:
    64@H, 128@H/2, 256@H/4, 512@H/8, 512@H/16 (pre-BN)."""

    def __init__(self):
        super().__init__()
        feats = vgg16_bn_features()
        names = ("down1", "down2", "down3", "down4", "down5", "down5_")
        for name, a, b in zip(names, _CUTS[:-1], _CUTS[1:]):
            setattr(self, name, feats[a:b])

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        taps = []
        for block in (self.down1, self.down2, self.down3, self.down4, self.down5):
            x = block(x)
            taps.append(x)
        return taps
