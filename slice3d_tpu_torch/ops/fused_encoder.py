"""Fused post-LN encoder layer of the SDF head: CUDA kernel and plain twin.

Replaces ``slice3d_tpu/ops/pallas_encoder.py::fused_encoder_layer``.  The
kernel (``csrc/fused_encoder.cu``) is written by hand for Hopper (sm_90a);
its source note says what bounds it and how the design answers that.

``fused_encoder_layer`` takes a CPU tensor to ``fused_encoder_layer_ref`` and
a CUDA tensor to the kernel, which takes bf16 activations only and raises on
anything else.  Both round to the activation dtype at the same points as the
TPU kernel's default body (``_layer_kernel_bdq``): q/k/v after their bias,
the softmax probabilities, the attention output, h1 after the first
LayerNorm and the ReLU output; the products accumulate, and the softmax and
both LayerNorms run, in fp32.

``params`` holds one layer's tensors under the reference torch names (the
keys of ``TransformerEncoderLayer.named_parameters()``):
``self_attn.in_proj_weight`` (3D, D), ``self_attn.in_proj_bias``,
``self_attn.out_proj.weight`` (D, D), ``self_attn.out_proj.bias``,
``linear1.weight`` (F, D), ``linear1.bias``, ``linear2.weight`` (D, F),
``linear2.bias``, ``norm1.weight``/``bias`` and ``norm2.weight``/``bias``.
"""

from __future__ import annotations

import ctypes
import os
from typing import Mapping

import torch

__all__ = ["fused_encoder_layer", "fused_encoder_layer_ref", "launches"]

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
_SRC = os.path.join(_CSRC, "fused_encoder.cu")
_HDR = os.path.join(_CSRC, "ffn_tile.cuh")  # the FFN loop, shared with fused_ffn.cu

# kernel launches made through fused_encoder_layer (see chip_smoke.py)
launches = 0

_WEIGHTS = ("self_attn.in_proj_weight", "self_attn.out_proj.weight",
            "linear1.weight", "linear2.weight")
_VECTORS = ("self_attn.in_proj_bias", "self_attn.out_proj.bias",
            "norm1.weight", "norm1.bias", "linear1.bias", "linear2.bias",
            "norm2.weight", "norm2.bias")


def _layer_norm(v: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    mu = v.mean(-1, keepdim=True)
    var = ((v - mu) ** 2).mean(-1, keepdim=True)
    return (v - mu) * torch.rsqrt(var + 1e-5) * w + b


def fused_encoder_layer_ref(x: torch.Tensor, params: Mapping[str, torch.Tensor], *,
                            n_heads: int = 4, head_tokens: int = 0) -> torch.Tensor:
    """Plain PyTorch layer: x (B, M, T, D) -> (B, M, T_out, D), T_out =
    ``head_tokens or T``.  Products run in fp32 on operands already rounded
    to x's dtype, so on the card it is the kernel's arithmetic in another
    summation order."""
    dt = x.dtype
    d = x.shape[-1]
    dh = d // n_heads
    f32 = torch.float32

    def mm(a, w):  # a (..., K) @ w(out, K)^T in fp32 on dt-rounded operands
        return torch.matmul(a.to(f32), w.to(dt).to(f32).t())

    def vec(name):
        return params[name].to(f32)

    qkv = (mm(x, params["self_attn.in_proj_weight"])
           + vec("self_attn.in_proj_bias")).to(dt)
    q, k, v = qkv.split(d, dim=-1)
    x_res = x
    if head_tokens:
        q = q[..., :head_tokens, :]
        x_res = x[..., :head_tokens, :]

    def heads(t):  # (..., T, D) -> (..., H, T, Dh)
        return t.reshape(t.shape[:-1] + (n_heads, dh)).transpose(-2, -3)

    q, k, v = heads(q), heads(k), heads(v)
    logits = torch.matmul(q.to(f32), k.to(f32).transpose(-1, -2)) * (1.0 / dh ** 0.5)
    probs = torch.softmax(logits, dim=-1).to(dt)
    o = torch.matmul(probs.to(f32), v.to(f32)).to(dt)
    o = o.transpose(-2, -3).reshape(o.shape[:-3] + (o.shape[-2], d))
    attn = mm(o, params["self_attn.out_proj.weight"]) + vec("self_attn.out_proj.bias")
    h1 = _layer_norm(x_res.to(f32) + attn, vec("norm1.weight"), vec("norm1.bias")).to(dt)
    ff = torch.relu(mm(h1, params["linear1.weight"]) + vec("linear1.bias")).to(dt)
    ff = mm(ff, params["linear2.weight"]) + vec("linear2.bias")
    out = _layer_norm(h1.to(f32) + ff, vec("norm2.weight"), vec("norm2.bias"))
    return out.to(dt)


_KERNEL = None  # the library's entry point, bound once per process


def kernel():
    """The kernel's C entry point: built (if stale, nvcc for sm_90a) and
    bound on the first call, then cached, so a launch never reaches
    ``native``."""
    global _KERNEL
    if _KERNEL is None:
        from ..native import build_library, nvcc_path

        lib = build_library(
            "s3d_fused_encoder", [_SRC],
            [nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"], headers=[_HDR])
        fn = lib.s3d_fused_encoder_layer
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        _KERNEL = fn
    return _KERNEL


def _on_card(x: torch.Tensor) -> bool:
    """True for a CUDA tensor (the kernel), False for a CPU one (the plain
    version); any other device raises."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_encoder_layer: unsupported device {x.device}")
    return x.device.type == "cuda"


def fused_encoder_layer(x: torch.Tensor, params: Mapping[str, torch.Tensor], *,
                        n_heads: int = 4, head_tokens: int = 0) -> torch.Tensor:
    """x: (B, M, T, D) -> (B, M, T_out, D).

    A CPU tensor takes the plain version.  A CUDA tensor launches the kernel,
    which needs bf16 x, D = 128, 4 heads, T <= 16, F a multiple of 64 and
    head_tokens in {0, 1}; anything else raises.  The kernel has no backward:
    with grad mode on and x or a weight that requires grad it raises rather
    than return a tensor cut from the graph.
    """
    global launches
    if not _on_card(x):
        return fused_encoder_layer_ref(x, params, n_heads=n_heads,
                                       head_tokens=head_tokens)
    if torch.is_grad_enabled() and (x.requires_grad
                                    or any(p.requires_grad for p in params.values())):
        raise RuntimeError("fused_encoder_layer kernel is inference only (it has no "
                           "backward, like the TPU kernel it replaces): run it under "
                           "torch.no_grad(), or build the layer with route='plain' "
                           "to train through the plain version")
    b, m, t, d = x.shape
    f = params["linear1.weight"].shape[0]
    if x.dtype != torch.bfloat16:
        raise TypeError(f"fused_encoder_layer kernel takes bf16, got {x.dtype}")
    if d != 128 or n_heads != 4 or not 1 <= t <= 16 or f % 64 or f <= 0:
        raise ValueError(f"fused_encoder_layer kernel: unsupported shape "
                         f"T={t} D={d} F={f} heads={n_heads}")
    if head_tokens not in (0, 1):
        raise ValueError(f"fused_encoder_layer kernel: head_tokens={head_tokens}")
    expect = {"self_attn.in_proj_weight": (3 * d, d),
              "self_attn.out_proj.weight": (d, d),
              "linear1.weight": (f, d), "linear2.weight": (d, f)}
    ws = {}
    for name in _WEIGHTS:
        w = params[name]
        if tuple(w.shape) != expect[name] or w.device != x.device:
            raise ValueError(f"fused_encoder_layer: bad {name} {tuple(w.shape)} "
                             f"on {w.device}")
        ws[name] = w.to(torch.bfloat16).contiguous()
    vs = {}
    for name in _VECTORS:
        v = params[name]
        if v.device != x.device:
            raise ValueError(f"fused_encoder_layer: {name} on {v.device}")
        vs[name] = v.to(torch.float32).contiguous()

    n = b * m
    xf = x.reshape(n, t, d).contiguous()
    t_out = head_tokens or t
    out = torch.empty((n, t_out, d), dtype=x.dtype, device=x.device)
    if n == 0:
        return out.reshape(b, m, t_out, d)
    launch = kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = launch(
            xf.data_ptr(),
            ws["self_attn.in_proj_weight"].data_ptr(), vs["self_attn.in_proj_bias"].data_ptr(),
            ws["self_attn.out_proj.weight"].data_ptr(), vs["self_attn.out_proj.bias"].data_ptr(),
            vs["norm1.weight"].data_ptr(), vs["norm1.bias"].data_ptr(),
            ws["linear1.weight"].data_ptr(), vs["linear1.bias"].data_ptr(),
            ws["linear2.weight"].data_ptr(), vs["linear2.bias"].data_ptr(),
            vs["norm2.weight"].data_ptr(), vs["norm2.bias"].data_ptr(),
            out.data_ptr(), n, t, f, head_tokens, stream)
    if rc != 0:
        raise RuntimeError(f"fused_encoder_layer kernel launch failed: CUDA error {rc}")
    launches += 1
    return out.reshape(b, m, t_out, d)
