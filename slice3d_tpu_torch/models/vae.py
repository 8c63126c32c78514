"""kl-f8 AutoencoderKL, the LDM's frozen first stage.

CompVis latent-diffusion's ``AutoencoderKL`` at the kl-f8 config (ch 128,
ch_mult (1, 2, 4, 4), 2 res blocks, z 4, double_z): ResNet encoder/decoder
with one mid attention block, GroupNorm(32, eps 1e-6), swish, nearest x2
upsampling and strided downsampling with torch's asymmetric (0, 1, 0, 1)
padding.  Parameter names are the reference's (``encoder.down.{i}.block.{j}``,
``encoder.mid.attn_1``, ``decoder.up.{i}.upsample.conv``, ``quant_conv``,
...), the ones ``torch_import.autoencoder_kl`` reads.  Public methods take
and return NHWC; the layers run NCHW inside.

The mid ``AttnBlock`` attends over (H/8 * W/8) tokens with one head as wide as
the block; the JAX package computes it outside Pallas, and so does this
module (plain matmuls, logits rounded to the compute dtype before the fp32
softmax, as ``jnp.einsum(...).astype(f32)`` does).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv2d, GroupNorm

__all__ = ["ResnetBlock", "AttnBlock", "Downsample", "Upsample", "Encoder", "Decoder",
           "AutoencoderKL", "DiagonalGaussian"]


def _gn(c: int) -> GroupNorm:
    return GroupNorm(32, c, eps=1e-6)


class _Level(nn.Module):
    """Holder of one resolution level (``block`` list, optional resampler)."""


class ResnetBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.norm1 = _gn(cin)
        self.conv1 = Conv2d(cin, cout, 3, padding=1)
        self.norm2 = _gn(cout)
        self.conv2 = Conv2d(cout, cout, 3, padding=1)
        if cin != cout:
            self.nin_shortcut = Conv2d(cin, cout, 1)

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if hasattr(self, "nin_shortcut"):
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head self-attention over the map's pixels."""

    def __init__(self, c: int):
        super().__init__()
        self.norm = _gn(c)
        self.q = Conv2d(c, c, 1)
        self.k = Conv2d(c, c, 1)
        self.v = Conv2d(c, c, 1)
        self.proj_out = Conv2d(c, c, 1)

    def forward(self, x):
        b, c, h, w = x.shape
        hn = self.norm(x)
        q = self.q(hn).reshape(b, c, h * w).transpose(1, 2)  # (b, t, c)
        k = self.k(hn).reshape(b, c, h * w)                  # (b, c, t)
        v = self.v(hn).reshape(b, c, h * w).transpose(1, 2)
        logits = torch.matmul(q, k).to(torch.float32)
        probs = torch.softmax(logits * c ** -0.5, dim=-1).to(v.dtype)
        out = torch.matmul(probs, v).transpose(1, 2).reshape(b, c, h, w)
        return x + self.proj_out(out)


class Downsample(nn.Module):
    """Stride-2 conv after (0, 1, 0, 1) zero padding."""

    def __init__(self, c: int):
        super().__init__()
        self.conv = Conv2d(c, c, 3, stride=2)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Upsample(nn.Module):
    """Nearest x2, then a 3x3 conv."""

    def __init__(self, c: int):
        super().__init__()
        self.conv = Conv2d(c, c, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class _Mid(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.block_1 = ResnetBlock(c, c)
        self.attn_1 = AttnBlock(c)
        self.block_2 = ResnetBlock(c, c)

    def forward(self, h):
        return self.block_2(self.attn_1(self.block_1(h)))


class Encoder(nn.Module):
    """(N, 3, H, W) -> (N, 2 z, H/f, W/f) with f = 2^(len(ch_mult) - 1)."""

    fsdp_unit = True  # its parameters are read within its forward alone: sharded, one gather

    def __init__(self, ch: int = 128, ch_mult: Sequence[int] = (1, 2, 4, 4),
                 num_res_blocks: int = 2, z_channels: int = 4, double_z: bool = True):
        super().__init__()
        self.conv_in = Conv2d(3, ch, 3, padding=1)
        self.down = nn.ModuleList()
        cin = ch
        for i, mult in enumerate(ch_mult):
            level = _Level()
            level.block = nn.ModuleList()
            for _ in range(num_res_blocks):
                level.block.append(ResnetBlock(cin, ch * mult))
                cin = ch * mult
            if i + 1 < len(ch_mult):
                level.downsample = Downsample(cin)
            self.down.append(level)
        self.mid = _Mid(cin)
        self.norm_out = _gn(cin)
        self.conv_out = Conv2d(cin, 2 * z_channels if double_z else z_channels, 3, padding=1)

    def forward(self, x):
        h = self.conv_in(x)
        for level in self.down:
            for block in level.block:
                h = block(h)
            if hasattr(level, "downsample"):
                h = level.downsample(h)
        h = self.mid(h)
        return self.conv_out(F.silu(self.norm_out(h)))


class Decoder(nn.Module):
    """(N, z, h, w) -> (N, 3, f h, f w); ``up[i]`` is level i, run from the
    deepest level up, as in the reference."""

    fsdp_unit = True  # its parameters are read within its forward alone: sharded, one gather

    def __init__(self, ch: int = 128, ch_mult: Sequence[int] = (1, 2, 4, 4),
                 num_res_blocks: int = 2, z_channels: int = 4, out_ch: int = 3):
        super().__init__()
        cin = ch * ch_mult[-1]
        self.conv_in = Conv2d(z_channels, cin, 3, padding=1)
        self.mid = _Mid(cin)
        self.up = nn.ModuleList(_Level() for _ in ch_mult)
        for i in reversed(range(len(ch_mult))):
            level = self.up[i]
            level.block = nn.ModuleList()
            for _ in range(num_res_blocks + 1):
                level.block.append(ResnetBlock(cin, ch * ch_mult[i]))
                cin = ch * ch_mult[i]
            if i > 0:
                level.upsample = Upsample(cin)
        self.norm_out = _gn(cin)
        self.conv_out = Conv2d(cin, out_ch, 3, padding=1)

    def forward(self, z):
        h = self.mid(self.conv_in(z))
        for i in reversed(range(len(self.up))):
            level = self.up[i]
            for block in level.block:
                h = block(h)
            if hasattr(level, "upsample"):
                h = level.upsample(h)
        return self.conv_out(F.silu(self.norm_out(h)))


class DiagonalGaussian:
    """Moments (..., 2 z) NHWC -> mean, clipped logvar, std; ``sample``
    takes its standard-normal noise from the caller or a generator."""

    def __init__(self, moments: torch.Tensor):
        self.mean, logvar = torch.chunk(moments, 2, dim=-1)
        self.logvar = torch.clamp(logvar, -30.0, 20.0)
        self.std = torch.exp(0.5 * self.logvar)

    def sample(self, noise: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if noise is None:
            noise = torch.randn(self.mean.shape, generator=generator,
                                dtype=self.mean.dtype, device=self.mean.device)
        return self.mean + self.std * noise.to(self.mean)

    def kl(self) -> torch.Tensor:
        """KL to the standard normal, summed over (h, w, z): (N,)."""
        return 0.5 * torch.sum(self.mean ** 2 + torch.exp(self.logvar) - 1.0 - self.logvar,
                               dim=(1, 2, 3))


class AutoencoderKL(nn.Module):
    """``dtype`` is the compute dtype (None: the input's); parameters stay
    fp32 and are cast at use."""

    def __init__(self, embed_dim: int = 4, ch: int = 128,
                 ch_mult: Sequence[int] = (1, 2, 4, 4), num_res_blocks: int = 2,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.downscale = 2 ** (len(ch_mult) - 1)
        self.encoder = Encoder(ch, ch_mult, num_res_blocks, embed_dim)
        self.decoder = Decoder(ch, ch_mult, num_res_blocks, embed_dim)
        self.quant_conv = Conv2d(2 * embed_dim, 2 * embed_dim, 1)
        self.post_quant_conv = Conv2d(embed_dim, embed_dim, 1)

    def _nchw(self, x: torch.Tensor) -> torch.Tensor:
        return x.permute(0, 3, 1, 2).to(self.dtype or x.dtype).contiguous()

    def encode_moments(self, x: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 3) -> (N, H/f, W/f, 2 z) gaussian moments."""
        return self.quant_conv(self.encoder(self._nchw(x))).permute(0, 2, 3, 1)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """(N, h, w, z) latents -> (N, f h, f w, 3) images."""
        return self.decoder(self.post_quant_conv(self._nchw(z))).permute(0, 2, 3, 1)

    def forward(self, x: torch.Tensor, noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        """(N, H, W, 3) -> (reconstruction from a posterior sample, moments);
        the sample's noise (N, h, w, z) from the caller or ``generator``."""
        moments = self.encode_moments(x)
        return self.decode(DiagonalGaussian(moments).sample(noise, generator)), moments
