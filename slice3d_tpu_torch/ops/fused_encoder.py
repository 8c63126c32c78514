"""Fused post-LN encoder layer of the SDF head: CUDA kernel and plain twin.

Replaces ``slice3d_tpu/ops/pallas_encoder.py::fused_encoder_layer``, which
the JAX package runs at the model's compute dtype, bf16 or fp32.  The
kernels are written by hand for Hopper (sm_90a), one a dtype: bf16 in
``csrc/fused_encoder.cu`` (``wgmma``/TMA), fp32 in
``csrc/fused_encoder_f32x3.cu`` on ``csrc/ffn_tile_f32x3.cuh`` (``wgmma`` in
3xTF32: each fp32 product with a weight as three TF32 products of operands
split into a hi and a lo TF32 part, which keeps fp32's accuracy; the
attention core, softmax and LayerNorms in fp32 on the CUDA cores); their
source notes say what bounds them and how the design answers that.

``fused_encoder_layer`` takes a CPU tensor to ``fused_encoder_layer_ref`` and
a CUDA tensor to the kernel of its dtype (``kernel_dtype``: bf16 or fp32),
and raises on anything else.  Each kernel counts its launches: ``launches``
(bf16), ``launches_f32`` (fp32).  Both versions round to the activation
dtype at the same points as the TPU kernel's default body
(``_layer_kernel_bdq``): q/k/v after their bias, the softmax probabilities,
the attention output, h1 after the first LayerNorm and the ReLU output; the
products accumulate, and the softmax and both LayerNorms run, in fp32.  In
fp32 every rounding is the identity, and the fp32 kernel differs from the
plain version by the rounding of its split products (at the fp32 level),
summation order and the exponential.

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
from typing import Mapping, Tuple

import torch

from .fused_ffn import NVCC_FLAGS, ffn_stream_f32x3, planes, tf32_split
from .prepared import KERNEL_DTYPES, aligned, one_kernel_dtype, prepare

__all__ = ["fused_encoder_layer", "fused_encoder_layer_ref", "kernel_dtype", "KERNEL_DTYPES",
           "launches", "launches_f32"]

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
_SRC = os.path.join(_CSRC, "fused_encoder.cu")
# the F-tile loop (shared with fused_ffn.cu) and the Hopper pieces it is built from
_HDRS = [os.path.join(_CSRC, "ffn_tile.cuh"), os.path.join(_CSRC, "attention_sm90.cuh")]
_SRC_F32 = os.path.join(_CSRC, "fused_encoder_f32x3.cu")
# its F-tile loop and the Hopper pieces (TF32 split, planes, wgmma) it is built from
_HDRS_F32 = [os.path.join(_CSRC, "ffn_tile_f32x3.cuh"), os.path.join(_CSRC, "attention_sm90.cuh")]

# kernel launches made through fused_encoder_layer, bf16 and fp32 (see
# chip_smoke.py)
launches = 0
launches_f32 = 0

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


# Tile constants of the kernels' sources (tests/test_torch_ffn.py ties them
# to the .cu and .cuh files): F is taken in F-tiles of FT, and a token tile
# holds ROWS rows (ROWS // T whole points, or at most ROWS points with
# head_tokens = 1 in bf16) of points of at most MAX_T tokens; the fp32
# kernels' attention takes ROWS // T whole points a tile and the rest ROWS
# rows of its output, over NH heads of DH, the attention's weight items KC
# K-columns of a head's q|k|v rows (ATTN_STAGES of them in its ring)
KERNEL_TILES = {"ffn_tile.cuh": {"D": 128, "FT": 64, "ROWS": 128, "STAGES": 3},
                "fused_encoder.cu": {"MAX_T": 16},
                "ffn_tile_f32x3.cuh": {"D": 128, "FT": 32, "ROWS": 128, "STAGES": 3},
                "fused_encoder_f32x3.cu": {"NH": 4, "DH": 32, "MAX_T": 16, "KC": 16,
                                           "ATTN_STAGES": 4}}
F_MULTIPLE = KERNEL_TILES["ffn_tile.cuh"]["FT"]
_ROWS = KERNEL_TILES["ffn_tile.cuh"]["ROWS"]


def weight_bytes_per_call(n: int, t: int, head_tokens: int, f: int = 2048,
                          grid: int = 132, dtype: torch.dtype = torch.bfloat16) -> int:
    """Bytes of weights the kernel of ``dtype`` fetches from L2 in one call
    over n points of t tokens, counted from its tiling (not read from the
    card).  bf16: every block reads Wqkv, Wo, W1 and W2 once a tile.  A tile
    holds ROWS // t points, or with head_tokens = 1 as few points (at most
    ROWS) as keep the rounds of a persistent grid of ``grid`` blocks (one an
    SM: 132 on the H100) that ROWS-point tiles would take, as the kernel
    chooses.  fp32: the attention kernel reads Wqkv once a tile of ROWS // t
    points, the rest Wo, W1 and W2 once a tile of ROWS output rows, each
    weight as a hi and a lo TF32 plane (8 bytes)."""
    d = KERNEL_TILES["ffn_tile.cuh"]["D"]
    if dtype == torch.float32:
        rows = KERNEL_TILES["ffn_tile_f32x3.cuh"]["ROWS"]
        attn_tiles = -(-n // (rows // t))
        post_tiles = -(-(n * (head_tokens or t)) // rows)
        return 8 * (attn_tiles * 3 * d * d + post_tiles * (d * d + 2 * d * f))
    if head_tokens:
        rounds = -(-(-(-n // _ROWS)) // grid)
        tile_pts = -(-n // (rounds * grid))
    else:
        tile_pts = _ROWS // t
    tiles = -(-n // tile_pts)
    per_tile = 2 * (4 * d * d + 2 * d * f)
    return tiles * per_tile


_LIB = None  # the bf16 library, bound once per process
_KERNEL = None  # its launch entry point
_LIB_F32 = None  # the fp32 library
_KERNEL_F32 = None  # its launch entry point


def kernel(dtype: torch.dtype = torch.bfloat16):
    """The launch entry point of ``dtype``'s kernel: built (if stale, nvcc
    for sm_90a) and bound on the first call, then cached, so a launch never
    reaches ``native``."""
    global _LIB, _KERNEL, _LIB_F32, _KERNEL_F32
    f32 = dtype == torch.float32
    if (_KERNEL_F32 if f32 else _KERNEL) is None:
        from ..native import build_library, nvcc_path

        lib = build_library("s3d_fused_encoder_f32" if f32 else "s3d_fused_encoder",
                            [_SRC_F32 if f32 else _SRC], [nvcc_path(), *NVCC_FLAGS],
                            headers=_HDRS_F32 if f32 else _HDRS)
        fn = lib.s3d_fused_encoder_f32 if f32 else lib.s3d_fused_encoder_layer
        fn.restype = ctypes.c_int
        # fp32: the two weight streams and the o scratch in place of the maps
        fn.argtypes = ([ctypes.c_void_p] * (13 if f32 else 11) + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
        if f32:
            _LIB_F32, _KERNEL_F32 = lib, fn
        else:
            _LIB, _KERNEL = lib, fn
    return _KERNEL_F32 if f32 else _KERNEL


def library(dtype: torch.dtype = torch.bfloat16) -> ctypes.CDLL:
    """The library of ``dtype``'s kernel (built by ``kernel``): besides the
    launch it exports the kernels' resident blocks an SM
    (``s3d_fused_encoder_blocks_per_sm``,
    ``s3d_fused_encoder_f32_blocks_per_sm``) and, bf16, the weight maps'
    encoder."""
    kernel(dtype)
    return _LIB_F32 if dtype == torch.float32 else _LIB


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


def _items(w: torch.Tensor, k: int) -> torch.Tensor:
    """(..., R, K) matrices cut along K into items of k columns, each as its
    hi and its lo TF32 plane (``fused_ffn.tf32_split``, ``fused_ffn.planes``):
    (..., K // k, 2, R * k)."""
    *lead, r, kk = w.shape
    chunks = w.reshape(*lead, r, kk // k, k).transpose(-3, -2)
    return torch.stack(tf32_split(planes(chunks)), -2)


def _pack_f32(wqkv: torch.Tensor, wo: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor):
    """The fp32 kernels' weight streams (csrc/fused_encoder_f32x3.cu), flat:
    the attention kernel's, per head its 3 DH rows (row ``which * DH + c`` =
    ``wqkv[which * D + h * DH + c]``, which 0 q, 1 k, 2 v) in items of KC
    K-columns (``_items``); the rest's, Wo's rows in items of the FFN's FT
    K-columns, then the FFN's stream (``fused_ffn.ffn_stream_f32x3``)."""
    tiles = KERNEL_TILES["fused_encoder_f32x3.cu"]
    nh, dh, kc = tiles["NH"], tiles["DH"], tiles["KC"]
    d = wo.shape[0]
    heads = wqkv.reshape(3, nh, dh, d).transpose(0, 1).reshape(nh, 3 * dh, d)
    wo_items = _items(wo, KERNEL_TILES["ffn_tile_f32x3.cuh"]["FT"])
    return (_items(heads, kc).reshape(-1),
            torch.cat((wo_items.reshape(-1), ffn_stream_f32x3(w1, w2))))


def prepared_params(params: Mapping[str, torch.Tensor], dtype: torch.dtype = torch.bfloat16):
    """The layer's weight set for the kernel of ``dtype``, made once per
    weight set (``ops/prepared.py``): the weights in bf16, in the order of
    ``_WEIGHTS``, or the fp32 streams of ``_pack_f32``, and the vectors in
    fp32 in the order of ``_VECTORS``."""
    return prepare("fused_encoder_layer", [params[k] for k in _WEIGHTS],
                   [params[k] for k in _VECTORS], dtype=dtype,
                   pack=_pack_f32 if dtype == torch.float32 else None)


def kernel_dtype(*named: Tuple[str, torch.Tensor]) -> torch.dtype:
    """The one dtype of the named tensors, which must be a kernel's
    (``KERNEL_DTYPES``): a ``TypeError`` names the first that is not, or
    that differs from the first tensor's.  Reads dtypes only, on any device."""
    return one_kernel_dtype("fused_encoder_layer", named)


def fused_encoder_layer(x: torch.Tensor, params: Mapping[str, torch.Tensor], *,
                        n_heads: int = 4, head_tokens: int = 0) -> torch.Tensor:
    """x: (B, M, T, D) -> (B, M, T_out, D).

    A CPU tensor takes the plain version.  A CUDA tensor launches the kernel
    of x's dtype, which needs bf16 or fp32 x, D = 128, 4 heads, 1 <= T <= 16,
    F a positive multiple of 64 (the kernels' F-tile, ``F_MULTIPLE``) and
    head_tokens in {0, 1}; anything else raises.  The kernels have no
    backward: with grad mode on and x or a weight that requires grad it
    raises rather than return a tensor cut from the graph.
    """
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
    dtype = kernel_dtype(("x", x))
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
    return _launch_kernel(x, params, head_tokens, dtype)


def _launch_kernel(x: torch.Tensor, params: Mapping[str, torch.Tensor], head_tokens: int,
                   dtype: torch.dtype) -> torch.Tensor:
    """Launch ``dtype``'s kernel on a checked x (B, M, T, D) and its layer's
    parameters -> (B, M, T_out, D)."""
    global launches, launches_f32
    b, m, t, d = x.shape
    f = params["linear1.weight"].shape[0]
    n = b * m
    xf = aligned(x.reshape(n, t, d))
    t_out = head_tokens or t
    out = torch.empty((n, t_out, d), dtype=x.dtype, device=x.device)
    if n == 0:
        return out.reshape(b, m, t_out, d)
    f32 = dtype == torch.float32
    launch = kernel(dtype)
    prep = prepared_params(params, dtype)
    vectors = [v.data_ptr() for v in prep.vectors]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if f32:  # the attention kernel's output o goes through a scratch
            o = torch.empty((n * t_out, d), dtype=x.dtype, device=x.device)
            rc = launch(xf.data_ptr(), *(w.data_ptr() for w in prep.weights), *vectors,
                        o.data_ptr(), out.data_ptr(), n, t, f, head_tokens, stream)
        else:
            rc = launch(xf.data_ptr(), ctypes.addressof(_maps(prep)), *vectors,
                        out.data_ptr(), n, t, f, head_tokens, stream)
    if rc != 0:
        raise RuntimeError(f"fused_encoder_layer {dtype} kernel launch failed: CUDA error {rc}")
    if f32:
        launches_f32 += 1
    else:
        launches += 1
    return out.reshape(b, m, t_out, d)
