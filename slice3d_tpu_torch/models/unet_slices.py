"""Slice U-Net: one input view -> 12 slice images + a 5-level feature pyramid.

A VGG16-BN encoder over the view; a learned 128-d embedding per slice joins
the bottleneck; a ConvTranspose decoder runs with the batch expanded x12 (one
decode per slice).  The five decoder maps (512/256/128/64/32 channels) are
the 992-channel sampling pyramid.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
from torch import nn

from .layers import BatchNorm2d, Conv2d, ConvTranspose2d
from .vgg import VGG16BNBackbone

__all__ = ["DoubleConv", "Up", "SliceUNet"]


class DoubleConv(nn.Module):
    """(conv3x3 no-bias -> BN -> ReLU) x 2."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.double_conv = nn.Sequential(
            Conv2d(cin, cout, 3, padding=1, bias=False), BatchNorm2d(cout), nn.ReLU(),
            Conv2d(cout, cout, 3, padding=1, bias=False), BatchNorm2d(cout), nn.ReLU(),
        )

    def forward(self, x):
        return self.double_conv(x)


class Up(nn.Module):
    """ConvTranspose(k2, s2) upsample, concat with the skip (skip first),
    DoubleConv."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.up = ConvTranspose2d(cin, cin // 2, kernel_size=2, stride=2)
        self.conv = DoubleConv(cin, cout)

    def forward(self, x, skip):
        return self.conv(torch.cat([skip, self.up(x)], dim=1))


class _OutConv(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = Conv2d(cin, cout, kernel_size=1)

    def forward(self, x):
        return torch.tanh(self.conv(x))


class SliceUNet(VGG16BNBackbone):
    """The VGG trunk (``down1`` .. ``down5_``) plus the slice decoder, under
    the reference ``slices_generator`` names."""

    fsdp_unit = True  # forward reads ``emds.weight``: sharded, the U-Net gathers as one

    def __init__(self, n_slices: int = 12, dim_embed: int = 128):
        super().__init__()
        self.n_slices = n_slices
        self.trans_c = Conv2d(512 + dim_embed, 512, 1)
        for i, ch in enumerate((256, 128, 64, 32), start=1):
            setattr(self, f"up{i}", Up(2 * ch, ch))
            setattr(self, f"trans_up{i}", Conv2d(2 * ch, ch, 1))
        self.outc = _OutConv(32, 3)
        self.emds = nn.Embedding(n_slices, dim_embed)

    def forward(self, x: torch.Tensor) -> Tuple[List[torch.Tensor], torch.Tensor]:
        """x (B, 3, H, W) -> (5 pyramid maps (B*S, c, h, w), slices
        (B*S, 3, H, W) in [-1, 1])."""
        x1, x2, x3, x4, x5 = super().forward(x)
        b, _, h5, w5 = x5.shape
        s = self.n_slices

        def expand(t):  # (B, c, h, w) -> (B*S, c, h, w)
            return t.repeat_interleave(s, dim=0)

        emb = self.emds.weight.to(x5.dtype)  # (S, E), broadcast at the bottleneck
        embs = emb[None, :, :, None, None].expand(b, s, -1, h5, w5).reshape(b * s, -1, h5, w5)
        h = self.trans_c(torch.cat([expand(x5), embs], dim=1))
        feats = [h]
        for i, skip in enumerate((x4, x3, x2, x1), start=1):
            skip_t = getattr(self, f"trans_up{i}")(expand(skip))
            h = getattr(self, f"up{i}")(h, skip_t)
            feats.append(h)
        return feats, self.outc(h)
