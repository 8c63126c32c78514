"""ADM-style denoiser UNet with Slice3D's VGG feature-map injection.

The reference ``UNetModel`` at the Slice3D operating point: in 8 ch (noisy
4 ch atlas + 4 ch input-view latent tile), out 4 ch, model_channels 192,
channel_mult (1, 2, 2, 4, 4), 2 res blocks, attention at ds 1/2/4/8 with 8
heads, scale-shift norm, resblock up/down, GroupNorm(32, eps 1e-5).  The
conditioning maps f1..f5 are added to the activations after input blocks
0/4/7/10/12.  Parameter names are the reference's (``time_embed.{0,2}``,
``input_blocks.{n}.{m}``, ``middle_block.{m}``, ``output_blocks.{n}.{m}``,
``out.{0,2}``; qkv and proj_out are 1x1 Conv1d), the ones
``torch_import.ldm_unet`` reads.  Public methods take and return NHWC.

Attention routing mirrors the JAX ``AttentionBlock``: a block over
``T >= 1024`` tokens with ``T % 512 == 0`` calls ``spatial_attention`` (the
hand-written kernel on the card, its plain version on the CPU, or the plain
version everywhere when built with ``fused=False``); shorter ones take the
einsum path in plain torch, which rounds the logits to the compute dtype
before the fp32 softmax as ``jnp.einsum(...).astype(f32)`` does.  At the
operating point (64x64 atlas) that is 10 kernel launches per UNet call: 5
blocks at ds 1 (T 4096, DH 24) and 5 at ds 2 (T 1024, DH 48).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.spatial_attention import (attention_kernel_eligible, spatial_attention,
                                     spatial_attention_ref)
from .layers import Conv2d, GroupNorm, Linear

__all__ = ["timestep_embedding", "ResBlock", "AttentionBlock", "LDMUNet"]


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal embeddings (B,) -> (B, dim), cos first, fp32."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.to(torch.float32)[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def _gn(c: int) -> GroupNorm:
    return GroupNorm(32, c, eps=1e-5)


class _Conv1x1(nn.Conv1d):
    """The reference's 1x1 Conv1d, in the activation's dtype."""

    def forward(self, x):
        return F.conv1d(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class ResBlock(nn.Module):
    """Scale-shift-norm res block; ``updown`` +1 upsamples (nearest x2), -1
    downsamples (2x2 average), both applied to the branch and the skip."""

    def __init__(self, cin: int, cout: int, emb_dim: int, updown: int = 0):
        super().__init__()
        self.updown = updown
        self.in_layers = nn.Sequential(_gn(cin), nn.SiLU(), Conv2d(cin, cout, 3, padding=1))
        self.emb_layers = nn.Sequential(nn.SiLU(), Linear(emb_dim, 2 * cout))
        self.out_layers = nn.Sequential(_gn(cout), nn.SiLU(), nn.Identity(),
                                        Conv2d(cout, cout, 3, padding=1))
        if cin != cout:
            self.skip_connection = Conv2d(cin, cout, 1)

    def forward(self, x, emb):
        h = F.silu(self.in_layers[0](x))
        if self.updown == 1:
            h = F.interpolate(h, scale_factor=2.0, mode="nearest")
            x = F.interpolate(x, scale_factor=2.0, mode="nearest")
        elif self.updown == -1:
            h = F.avg_pool2d(h, 2)
            x = F.avg_pool2d(x, 2)
        h = self.in_layers[2](h)
        scale, shift = self.emb_layers(emb)[:, :, None, None].chunk(2, dim=1)
        h = F.silu(self.out_layers[0](h) * (1 + scale) + shift)
        h = self.out_layers[3](h)
        if hasattr(self, "skip_connection"):
            x = self.skip_connection(x)
        return x + h


class AttentionBlock(nn.Module):
    """Self-attention over the map's pixels with the legacy heads-major qkv
    layout: channel ``head * 3 ch + j * ch + d`` is q/k/v (j) of that head."""

    def __init__(self, c: int, n_heads: int = 8, fused: bool = True):
        super().__init__()
        self.n_heads = n_heads
        self.fused = fused
        self.norm = _gn(c)
        self.qkv = _Conv1x1(c, 3 * c, 1)
        self.proj_out = _Conv1x1(c, c, 1)

    def forward(self, x):
        b, c, hh, ww = x.shape
        t = hh * ww
        ch = c // self.n_heads
        qkv = self.qkv(self.norm(x).reshape(b, c, t)).reshape(b, self.n_heads, 3 * ch, t)
        q, k, v = (part.transpose(-1, -2) for part in qkv.split(ch, dim=2))  # (b, H, t, ch)
        if attention_kernel_eligible(t):
            fn = spatial_attention if self.fused else spatial_attention_ref
            out = fn(q, k, v, 1.0 / math.sqrt(ch))
        else:
            logits = torch.matmul(q, k.transpose(-1, -2)).to(torch.float32)
            probs = torch.softmax(logits / math.sqrt(ch), dim=-1).to(v.dtype)
            out = torch.matmul(probs, v)
        out = out.transpose(-1, -2).reshape(b, c, t)  # channel head * ch + d
        return x + self.proj_out(out).reshape(b, c, hh, ww)


class LDMUNet(nn.Module):
    """``dtype`` is the compute dtype (None: the input's); parameters stay
    fp32 and are cast at use.  ``fused=False`` keeps every attention block on
    the plain path: a kernel-free reference, at any dtype and on any device."""

    fsdp_unit = True  # its parameters are read within its forward alone: sharded, one gather

    def __init__(self, in_channels: int = 8, out_channels: int = 4,
                 model_channels: int = 192, channel_mult: Sequence[int] = (1, 2, 2, 4, 4),
                 num_res_blocks: int = 2, attention_ds: Sequence[int] = (1, 2, 4, 8),
                 n_heads: int = 8, fmap_inject_blocks: Sequence[int] = (0, 4, 7, 10, 12),
                 fused: bool = True, dtype: Optional[torch.dtype] = None):
        super().__init__()
        mc = model_channels
        emb = 4 * mc
        self.model_channels = mc
        self.dtype = dtype
        self.inject = {blk: f"f{i + 1}" for i, blk in enumerate(fmap_inject_blocks)}
        self.time_embed = nn.Sequential(Linear(mc, emb), nn.SiLU(), Linear(emb, emb))
        self.input_blocks = nn.ModuleList([nn.ModuleList([Conv2d(in_channels, mc, 3,
                                                                 padding=1)])])
        ch, ds, chans = mc, 1, [mc]
        for level, mult in enumerate(channel_mult):
            for _ in range(num_res_blocks):
                layers = [ResBlock(ch, mc * mult, emb)]
                ch = mc * mult
                if ds in attention_ds:
                    layers.append(AttentionBlock(ch, n_heads, fused))
                self.input_blocks.append(nn.ModuleList(layers))
                chans.append(ch)
            if level + 1 < len(channel_mult):
                self.input_blocks.append(nn.ModuleList([ResBlock(ch, ch, emb, updown=-1)]))
                chans.append(ch)
                ds *= 2
        self.middle_block = nn.ModuleList([ResBlock(ch, ch, emb),
                                           AttentionBlock(ch, n_heads, fused),
                                           ResBlock(ch, ch, emb)])
        self.output_blocks = nn.ModuleList()
        for level in reversed(range(len(channel_mult))):
            for i in range(num_res_blocks + 1):
                layers = [ResBlock(ch + chans.pop(), mc * channel_mult[level], emb)]
                ch = mc * channel_mult[level]
                if ds in attention_ds:
                    layers.append(AttentionBlock(ch, n_heads, fused))
                if level > 0 and i == num_res_blocks:
                    layers.append(ResBlock(ch, ch, emb, updown=1))
                    ds //= 2
                self.output_blocks.append(nn.ModuleList(layers))
        self.out = nn.Sequential(_gn(ch), nn.SiLU(), Conv2d(ch, out_channels, 3, padding=1))

    @staticmethod
    def _run(block: nn.ModuleList, h, emb):
        for layer in block:
            h = layer(h, emb) if isinstance(layer, ResBlock) else layer(h)
        return h

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                c_fmaps: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
        """x (B, H, W, in_ch); t (B,) timesteps; c_fmaps {'f1', ...} NHWC.
        Returns fp32 (B, H, W, out_ch)."""
        dt = self.dtype or x.dtype
        emb = self.time_embed(timestep_embedding(t, self.model_channels).to(dt))
        h = x.permute(0, 3, 1, 2).to(dt).contiguous()
        hs = []
        for bid, block in enumerate(self.input_blocks):
            h = self._run(block, h, emb)
            if c_fmaps is not None and bid in self.inject:
                h = h + c_fmaps[self.inject[bid]].permute(0, 3, 1, 2).to(h.dtype)
            hs.append(h)
        h = self._run(self.middle_block, h, emb)
        for block in self.output_blocks:
            h = self._run(block, torch.cat([h, hs.pop()], dim=1), emb)
        return self.out(h).to(torch.float32).permute(0, 2, 3, 1)
