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

from .prepared import prepare

__all__ = ["fused_encoder_layer", "fused_encoder_layer_ref", "launches"]

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
_SRC = os.path.join(_CSRC, "fused_encoder.cu")
# the F-tile loop (shared with fused_ffn.cu) and the Hopper pieces it is built from
_HDRS = [os.path.join(_CSRC, "ffn_tile.cuh"), os.path.join(_CSRC, "attention_sm90.cuh")]

# kernel launches made through fused_encoder_layer (see chip_smoke.py)
launches = 0

_WEIGHTS = ("self_attn.in_proj_weight", "self_attn.out_proj.weight",
            "linear1.weight", "linear2.weight")
_VECTORS = ("self_attn.in_proj_bias", "self_attn.out_proj.bias",
            "norm1.weight", "norm1.bias", "linear1.bias", "linear2.bias",
            "norm2.weight", "norm2.bias")  # the order of the kernel's arguments


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


# Tile constants of the kernel's sources (tests/test_torch_ffn.py ties them
# to the .cu and .cuh files): F is taken in F-tiles of FT, and a token tile
# holds ROWS rows (ROWS // T whole points, or at most ROWS points with
# head_tokens = 1) of points of at most MAX_T tokens
KERNEL_TILES = {"ffn_tile.cuh": {"D": 128, "FT": 64, "ROWS": 128, "STAGES": 3},
                "fused_encoder.cu": {"MAX_T": 16}}
F_MULTIPLE = KERNEL_TILES["ffn_tile.cuh"]["FT"]
_ROWS = KERNEL_TILES["ffn_tile.cuh"]["ROWS"]


def weight_bytes_per_call(n: int, t: int, head_tokens: int, f: int = 2048,
                          grid: int = 132) -> int:
    """Bytes of weights the kernel fetches from L2 in one call over n points
    of t tokens, counted from its tiling (not read from the card): every
    block reads Wqkv, Wo, W1 and W2 once a tile.  A tile holds ROWS // t
    points, or with head_tokens = 1 as few points (at most ROWS) as keep the
    rounds of a persistent grid of ``grid`` blocks (one an SM: 132 on the
    H100) that ROWS-point tiles would take, as the kernel chooses."""
    d = KERNEL_TILES["ffn_tile.cuh"]["D"]
    if head_tokens:
        rounds = -(-(-(-n // _ROWS)) // grid)
        tile_pts = -(-n // (rounds * grid))
    else:
        tile_pts = _ROWS // t
    tiles = -(-n // tile_pts)
    per_tile = 2 * (4 * d * d + 2 * d * f)
    return tiles * per_tile


_LIB = None  # the library, bound once per process
_KERNEL = None  # its launch entry point


def kernel():
    """The kernel's C entry point: built (if stale, nvcc for sm_90a) and
    bound on the first call, then cached, so a launch never reaches
    ``native``."""
    global _LIB, _KERNEL
    if _KERNEL is None:
        from ..native import build_library, nvcc_path

        lib = build_library(
            "s3d_fused_encoder", [_SRC],
            [nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"], headers=_HDRS)
        fn = lib.s3d_fused_encoder_layer
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        _LIB, _KERNEL = lib, fn
    return _KERNEL


def library() -> ctypes.CDLL:
    """The kernel's library (built by ``kernel``): besides the launch it
    exports the weight maps' encoder and the kernel's resident blocks an SM
    (``s3d_fused_encoder_blocks_per_sm``)."""
    kernel()
    return _LIB


def _maps(prep) -> ctypes.Array:
    """The weight set's TMA maps, encoded at its first launch."""
    if prep.maps is None:
        lib = library()
        encode = lib.s3d_fused_encoder_maps
        encode.restype = ctypes.c_int
        encode.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p]
        buf = ctypes.create_string_buffer(lib.s3d_fused_encoder_maps_bytes())
        wqkv, wo, w1, w2 = prep.weights
        rc = encode(wqkv.data_ptr(), wo.data_ptr(), w1.data_ptr(), w2.data_ptr(),
                    w1.shape[0], buf)
        if rc != 0:
            raise RuntimeError(f"fused_encoder_layer: weight maps not encoded ({rc})")
        prep.maps = buf
    return prep.maps


def _on_card(x: torch.Tensor) -> bool:
    """True for a CUDA tensor (the kernel), False for a CPU one (the plain
    version); any other device raises."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_encoder_layer: unsupported device {x.device}")
    return x.device.type == "cuda"


def prepared_params(params: Mapping[str, torch.Tensor]):
    """The layer's weights in bf16 and vectors in fp32, cast once per weight
    set (``ops/prepared.py``), in the order of ``_WEIGHTS`` and ``_VECTORS``."""
    return prepare("fused_encoder_layer", [params[k] for k in _WEIGHTS],
                   [params[k] for k in _VECTORS])


def fused_encoder_layer(x: torch.Tensor, params: Mapping[str, torch.Tensor], *,
                        n_heads: int = 4, head_tokens: int = 0) -> torch.Tensor:
    """x: (B, M, T, D) -> (B, M, T_out, D).

    A CPU tensor takes the plain version.  A CUDA tensor launches the kernel,
    which needs bf16 x, D = 128, 4 heads, 1 <= T <= 16, F a positive multiple
    of 64 (the kernel's F-tile, ``F_MULTIPLE``) and head_tokens in {0, 1};
    anything else raises.  The kernel has no backward: with grad mode on and
    x or a weight that requires grad it raises rather than return a tensor
    cut from the graph.
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
    if (d != 128 or n_heads != 4 or not 1 <= t <= KERNEL_TILES["fused_encoder.cu"]["MAX_T"]
            or f <= 0 or f % F_MULTIPLE):
        raise ValueError(f"fused_encoder_layer kernel: unsupported shape T={t} D={d} F={f} "
                         f"heads={n_heads} (it takes D 128, 4 heads, 1 <= T <= 16 and F a "
                         f"positive multiple of {F_MULTIPLE})")
    if head_tokens not in (0, 1):
        raise ValueError(f"fused_encoder_layer kernel: head_tokens={head_tokens}")
    expect = {"self_attn.in_proj_weight": (3 * d, d),
              "self_attn.out_proj.weight": (d, d),
              "linear1.weight": (f, d), "linear2.weight": (d, f)}
    for name in _WEIGHTS:
        w = params[name]
        if tuple(w.shape) != expect[name] or w.device != x.device:
            raise ValueError(f"fused_encoder_layer: bad {name} {tuple(w.shape)} "
                             f"on {w.device}")
    for name in _VECTORS:
        if params[name].device != x.device:
            raise ValueError(f"fused_encoder_layer: {name} on {params[name].device}")

    n = b * m
    xf = x.reshape(n, t, d).contiguous()
    t_out = head_tokens or t
    out = torch.empty((n, t_out, d), dtype=x.dtype, device=x.device)
    if n == 0:
        return out.reshape(b, m, t_out, d)
    launch = kernel()
    prep = prepared_params(params)
    maps = _maps(prep)
    bqkv, bo, g1, be1, b1, b2, g2, be2 = (v.data_ptr() for v in prep.vectors)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = launch(xf.data_ptr(), ctypes.addressof(maps), bqkv, bo, g1, be1, b1, b2, g2,
                    be2, out.data_ptr(), n, t, f, head_tokens, stream)
    if rc != 0:
        raise RuntimeError(f"fused_encoder_layer kernel launch failed: CUDA error {rc}")
    launches += 1
    return out.reshape(b, m, t_out, d)
