"""Shared building blocks: convolutions, BatchNorm, GroupNorm, the post-LN
transformer encoder.

Parameters stay fp32 and follow the activation's dtype at use, the way the
JAX modules cast their fp32 params to the compute dtype: a bf16 input runs a
bf16 layer.  Parameter names are the reference torch modules' names, so
reference ``state_dict``s load as they are.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed.nn.functional as dist_nn
import torch.nn.functional as F
from torch import nn

from ..ops.fused_encoder import fused_encoder_layer, fused_encoder_layer_ref
from ..ops.fused_ffn import fused_ffn
from ..parallel.mesh import data_group, in_group

__all__ = ["Conv2d", "ConvTranspose2d", "Linear", "BatchNorm2d", "GroupNorm",
           "TransformerEncoderLayer", "TransformerEncoder", "ROUTES"]


class Conv2d(nn.Conv2d):
    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, self.weight.to(x.dtype), b, self.stride, self.padding)


class ConvTranspose2d(nn.ConvTranspose2d):
    def forward(self, x):
        return F.conv_transpose2d(x, self.weight.to(x.dtype), self.bias.to(x.dtype),
                                  self.stride)


class Linear(nn.Linear):
    def forward(self, x):
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm with eps 1e-5, as flax's ``BatchNorm`` in the JAX package.

    ``train`` (default: ``self.training``) normalises with the batch's fp32
    mean and biased variance, ``E[x^2] - E[x]^2`` clipped at 0 (per-channel
    sums over the count), and moves the running statistics towards them by
    ``momentum`` (0.1: flax's 0.9), the variance biased too (torch's own
    BatchNorm keeps the unbiased one).  Otherwise the running statistics
    normalise.

    In a process group (a group of one too) the training statistics are the
    global batch's, as under the JAX package's jit over a sharded batch: one
    all-reduce over the data group (``parallel.data_group``: the processes
    of this one's model index, which together hold every batch row once;
    the whole group when the model axis is 1) of the per-channel sum, sum of
    squares and count, which autograd differentiates through (every process
    runs the same BatchNorms in the same order).  Without a group the same
    sums are taken, so the all-reduce is the only difference."""

    def forward(self, x, train: Optional[bool] = None):
        dt = x.dtype
        if not (self.training if train is None else train):
            return F.batch_norm(x, self.running_mean.to(dt), self.running_var.to(dt),
                                self.weight.to(dt), self.bias.to(dt), False, 0.0, self.eps)
        xf = x.to(torch.promote_types(dt, torch.float32))
        c = xf.shape[1]
        count = torch.full((1,), xf.numel() / c, dtype=xf.dtype, device=xf.device)
        totals = torch.cat([xf.sum((0, 2, 3)), (xf * xf).sum((0, 2, 3)), count])
        if in_group():  # the one arithmetic either way: a group of one changes no bit
            totals = dist_nn.all_reduce(totals, group=data_group())
        mean = totals[:c] / totals[2 * c]
        var = (totals[c:2 * c] / totals[2 * c] - mean * mean).clamp_min(0.0)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean.to(self.running_mean.dtype), alpha=m)
            self.running_var.mul_(1.0 - m).add_(var.to(self.running_var.dtype), alpha=m)
            self.num_batches_tracked += 1
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
        return y.to(dt)


class GroupNorm(nn.GroupNorm):
    """GroupNorm in the activation's dtype (statistics in fp32 inside)."""

    def forward(self, x):
        return F.group_norm(x, self.num_groups, self.weight.to(x.dtype),
                            self.bias.to(x.dtype), self.eps)


class _SelfAttention(nn.Module):
    """Parameter holder with ``nn.MultiheadAttention``'s names."""

    def __init__(self, d_model: int):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = nn.Linear(d_model, d_model)


def _layer_norm(v: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """LayerNorm (eps 1e-5) in v's dtype, op for op as the JAX layer's
    ``_layer_norm`` with its compute dtype."""
    mu = v.mean(-1, keepdim=True)
    var = ((v - mu) ** 2).mean(-1, keepdim=True)
    return (v - mu) * torch.rsqrt(var + 1e-5) * w.to(v.dtype) + b.to(v.dtype)


def split_encoder_layer(x: torch.Tensor, params, *, n_heads: int = 4,
                        head_tokens: int = 0) -> torch.Tensor:
    """The split-encoder route: x (..., T, D) -> (..., T_out, D), T_out =
    ``head_tokens or T``, in x's dtype (bf16 or fp32 on the card).  Op for op
    the JAX layer with ``fused_ffn=True`` and the whole-layer kernel switched
    off (``slice3d_tpu/models/layers.py:184-211``): qkv; logits in x's dtype,
    then cast to fp32 and scaled; fp32 softmax rounded to x's dtype; the
    attention output and out-proj; residual + LayerNorm in x's dtype; the FFN
    through ``fused_ffn`` (the kernel of x's dtype on the card, as the JAX
    layer's ``pallas_ffn.fused_ffn`` runs its kernel at x's dtype);
    residual + LayerNorm."""
    dt = x.dtype
    d = x.shape[-1]
    dh = d // n_heads

    def linear(a, name):
        return (torch.matmul(a, params[name + "weight"].to(dt).t())
                + params[name + "bias"].to(dt))

    qkv = linear(x, "self_attn.in_proj_")
    q, k, v = qkv.split(d, dim=-1)
    if head_tokens:
        q = q[..., :head_tokens, :]
        x = x[..., :head_tokens, :]

    def heads(t):  # (..., T, D) -> (..., H, T, Dh)
        return t.reshape(t.shape[:-1] + (n_heads, dh)).transpose(-2, -3)

    q, k, v = heads(q), heads(k), heads(v)
    scale = (1.0 / torch.sqrt(torch.tensor(float(dh)))).item()  # 1/sqrt(dh) in fp32
    logits = torch.matmul(q, k.transpose(-1, -2)).to(torch.float32) * scale
    probs = torch.softmax(logits, dim=-1).to(dt)
    attn = torch.matmul(probs, v).transpose(-2, -3)  # (..., T, H, Dh)
    attn = linear(attn.reshape(attn.shape[:-2] + (d,)), "self_attn.out_proj.")
    x = _layer_norm(x + attn, params["norm1.weight"], params["norm1.bias"])
    ff = fused_ffn(x, params["linear1.weight"], params["linear1.bias"],
                   params["linear2.weight"], params["linear2.bias"])
    return _layer_norm(x + ff, params["norm2.weight"], params["norm2.bias"])


# the encoder layer's routes: the whole-layer kernel, the JAX package's
# split-encoder fallback (attention as plain ops, the FFN kernel), the plain
# version of the whole layer
_ROUTE_FNS = {"fused": fused_encoder_layer, "split": split_encoder_layer,
              "plain": fused_encoder_layer_ref}
ROUTES = tuple(_ROUTE_FNS)


class TransformerEncoderLayer(nn.Module):
    """Post-LN encoder layer with ``nn.TransformerEncoderLayer``'s defaults
    (ReLU, LayerNorm eps 1e-5), inference only, input (B, M, T, D).

    ``head_tokens`` keeps only the first tokens after attention (the head's
    last layer reads token 0 alone).  ``route`` picks how it runs: ``"fused"``
    sends a CUDA input to the whole-layer kernel, ``"split"`` runs attention
    as plain ops and the FFN through the ``fused_ffn`` kernel, ``"plain"``
    runs the whole layer's plain version; the kernels run at the input's
    dtype, bf16 or fp32; a CPU input takes the kernels' plain versions on
    every route.
    """

    fsdp_unit = True  # forward reads its children's parameters: sharded, they gather here

    def __init__(self, d_model: int = 128, n_heads: int = 4, d_ff: int = 2048,
                 head_tokens: int = 0, route: str = "fused"):
        super().__init__()
        self.n_heads = n_heads
        self.head_tokens = head_tokens
        if route not in _ROUTE_FNS:
            raise ValueError(f"unknown encoder route {route!r}: expected one of {ROUTES}")
        self.route = route
        self.self_attn = _SelfAttention(d_model)
        self.linear1 = nn.Linear(d_model, d_ff)
        self.linear2 = nn.Linear(d_ff, d_model)
        self.norm1 = nn.LayerNorm(d_model)
        self.norm2 = nn.LayerNorm(d_model)
        nn.init.xavier_uniform_(self.self_attn.in_proj_weight)

    def forward(self, x: torch.Tensor, route: Optional[str] = None) -> torch.Tensor:
        """``route`` overrides the layer's own for this call (the mesh polish
        differentiates through the plain route)."""
        return _ROUTE_FNS[route or self.route](x, dict(self.named_parameters()),
                                               n_heads=self.n_heads,
                                               head_tokens=self.head_tokens)


class TransformerEncoder(nn.Module):
    """Stack of post-LN layers; the last keeps ``final_head_tokens`` tokens."""

    def __init__(self, num_layers: int = 3, d_model: int = 128, n_heads: int = 4,
                 d_ff: int = 2048, final_head_tokens: int = 0, route: str = "fused"):
        super().__init__()
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(d_model, n_heads, d_ff,
                                    final_head_tokens if i + 1 == num_layers else 0,
                                    route)
            for i in range(num_layers))

    def forward(self, x: torch.Tensor, route: Optional[str] = None) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x, route)
        return x
