"""Fused ReLU FFN of the split-encoder route: CUDA kernel and plain twin.

Replaces ``slice3d_tpu/ops/pallas_ffn.py::fused_ffn`` (the TPU kernel
``_fused_ffn_tpu``, body ``_kernel``).  The kernel (``csrc/fused_ffn.cu``) is
written by hand for Hopper (sm_90a); its source note says what bounds it and
how the design answers that.

``fused_ffn`` takes a CPU tensor to ``fused_ffn_ref`` and a CUDA tensor to
the kernel, which takes bf16 activations only and raises on anything else.
Both compute ``relu(x W1^T + b1) W2^T + b2`` per row with the TPU kernel's
rounding points: the weights in x's dtype, b1 and b2 in fp32, both products
accumulated in fp32, h rounded to x's dtype after the ReLU, the output
rounded to x's dtype.  The weights are in ``nn.Linear``'s layout:
``w1 = linear1.weight`` (F, D), ``w2 = linear2.weight`` (D, F) (the JAX
function takes their transposes).
"""

from __future__ import annotations

import ctypes
import os

import torch

from .prepared import prepare

__all__ = ["fused_ffn", "fused_ffn_ref", "launches"]

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
_SRC = os.path.join(_CSRC, "fused_ffn.cu")
# the F-tile loop (shared with fused_encoder.cu) and the Hopper pieces it is built from
_HDRS = [os.path.join(_CSRC, "ffn_tile.cuh"), os.path.join(_CSRC, "attention_sm90.cuh")]

# kernel launches made through fused_ffn (see chip_smoke.py)
launches = 0


def fused_ffn_ref(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                  b2: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch FFN over x's last axis: (..., D) -> (..., D2).  Products
    run in fp32 on operands already rounded to x's dtype, so on the card it
    is the kernel's arithmetic in another summation order."""
    dt, f32 = x.dtype, torch.float32
    h = torch.matmul(x.to(f32), w1.to(dt).to(f32).t()) + b1.to(f32)
    h = torch.relu(h).to(dt)
    return (torch.matmul(h.to(f32), w2.to(dt).to(f32).t()) + b2.to(f32)).to(dt)


# Tile constants of the kernel's sources (tests/test_torch_ffn.py ties them
# to the .cu and .cuh files): F is taken in F-tiles of FT, and a row tile
# holds 64 rows for each of CONSUMERS consumer warpgroups
KERNEL_TILES = {"ffn_tile.cuh": {"D": 128, "FT": 64, "ROWS": 128, "STAGES": 3},
                "fused_ffn.cu": {"CONSUMERS": 3}}
F_MULTIPLE = KERNEL_TILES["ffn_tile.cuh"]["FT"]
TILE_ROWS = 64 * KERNEL_TILES["fused_ffn.cu"]["CONSUMERS"]


def weight_bytes_per_call(n: int, f: int = 2048, tile_rows: int = TILE_ROWS) -> int:
    """Bytes of W1 and W2 the kernel fetches from L2 in one call over n rows,
    counted from its tiling (not read from the card): every block reads them
    once a row tile of ``tile_rows``."""
    return -(-n // tile_rows) * 2 * 2 * KERNEL_TILES["ffn_tile.cuh"]["D"] * f


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
            "s3d_fused_ffn", [_SRC],
            [nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"], headers=_HDRS)
        fn = lib.s3d_fused_ffn
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        _LIB, _KERNEL = lib, fn
    return _KERNEL


def library() -> ctypes.CDLL:
    """The kernel's library (built by ``kernel``): besides the launch it
    exports the weight maps' encoder and the kernel's resident blocks an SM
    (``s3d_fused_ffn_blocks_per_sm``)."""
    kernel()
    return _LIB


def _maps(prep) -> ctypes.Array:
    """The weight set's TMA maps, encoded at its first launch."""
    if prep.maps is None:
        lib = library()
        encode = lib.s3d_fused_ffn_maps
        encode.restype = ctypes.c_int
        encode.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p]
        buf = ctypes.create_string_buffer(lib.s3d_fused_ffn_maps_bytes())
        w1, w2 = prep.weights
        rc = encode(w1.data_ptr(), w2.data_ptr(), w1.shape[0], buf)
        if rc != 0:
            raise RuntimeError(f"fused_ffn: weight maps not encoded ({rc})")
        prep.maps = buf
    return prep.maps


def prepared_weights(w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor):
    """w1, w2 in bf16 and b1, b2 in fp32, cast once per weight set
    (``ops/prepared.py``)."""
    return prepare("fused_ffn", [w1, w2], [b1, b2])


def fused_ffn(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
              b2: torch.Tensor) -> torch.Tensor:
    """relu(x W1^T + b1) W2^T + b2 over x's last axis: (..., D) -> (..., D).

    A CPU tensor takes the plain version.  A CUDA tensor launches the kernel,
    which needs bf16 x, D = 128, F a positive multiple of 64 (the kernel's
    F-tile, ``F_MULTIPLE``) and every weight on x's device; anything else
    raises.  The kernel has no backward (like the TPU kernel it replaces):
    with grad mode on and x or a weight that requires grad it raises rather
    than return a tensor cut from the graph.
    """
    global launches
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_ffn: unsupported device {x.device}")
    if x.device.type == "cpu":
        return fused_ffn_ref(x, w1, b1, w2, b2)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, w1, b1, w2, b2)):
        raise RuntimeError("fused_ffn kernel is inference only (it has no backward, like "
                           "the TPU kernel it replaces): run it under torch.no_grad(), or "
                           "build the layer with route='plain' to train through the plain "
                           "version")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"fused_ffn kernel takes bf16, got {x.dtype}")
    d = x.shape[-1]
    f = w1.shape[0]
    if d != 128 or f <= 0 or f % F_MULTIPLE:
        raise ValueError(f"fused_ffn kernel: unsupported shape D={d} F={f} (it takes D 128 "
                         f"and F a positive multiple of {F_MULTIPLE})")
    expect = ((w1, (f, d)), (b1, (f,)), (w2, (d, f)), (b2, (d,)))
    for t, shape in expect:
        if tuple(t.shape) != shape or t.device != x.device:
            raise ValueError(f"fused_ffn: a weight of shape {tuple(t.shape)} on {t.device}, "
                             f"expected {shape} on {x.device}")
    xf = x.reshape(-1, d).contiguous()
    n = xf.shape[0]
    out = torch.empty((n, d), dtype=x.dtype, device=x.device)
    if n == 0:
        return out.reshape(x.shape)
    launch = kernel()
    prep = prepared_weights(w1, b1, w2, b2)
    maps = _maps(prep)
    b1f, b2f = prep.vectors
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = launch(xf.data_ptr(), ctypes.addressof(maps), b1f.data_ptr(), b2f.data_ptr(),
                    out.data_ptr(), n, f, stream)
    if rc != 0:
        raise RuntimeError(f"fused_ffn kernel launch failed: CUDA error {rc}")
    launches += 1
    return out.reshape(x.shape)
