"""Fused ReLU FFN of the split-encoder route: CUDA kernel and plain twin.

Replaces ``slice3d_tpu/ops/pallas_ffn.py::fused_ffn`` (the TPU kernel
``_fused_ffn_tpu``, body ``_kernel``), which the JAX package runs at the
input's dtype, bf16 or fp32.  The kernels are written by hand for Hopper
(sm_90a), one a dtype: bf16 in ``csrc/fused_ffn.cu`` (``wgmma``/TMA), fp32
in ``csrc/fused_ffn_f32x3.cu`` on ``csrc/ffn_tile_f32x3.cuh`` (``wgmma`` in
3xTF32: each fp32 product as three TF32 products of operands split into a
hi and a lo TF32 part, which keeps fp32's accuracy); their source notes say
what bounds them and how the design answers that.

``fused_ffn`` takes a CPU tensor to ``fused_ffn_ref`` and a CUDA tensor to
the kernel of its dtype (``kernel_dtype``: bf16 or fp32), and raises on
anything else.  Each kernel counts its launches: ``launches`` (bf16),
``launches_f32`` (fp32).  Both versions compute ``relu(x W1^T + b1) W2^T +
b2`` per row with the TPU kernel's rounding points: the weights in x's
dtype, b1 and b2 in fp32, both products accumulated in fp32, h rounded to
x's dtype after the ReLU, the output rounded to x's dtype.  In fp32 every
rounding is the identity, and the fp32 kernel differs from the plain version
by the rounding of its split products (at the fp32 level) and summation
order.  The weights are in ``nn.Linear``'s layout:
``w1 = linear1.weight`` (F, D), ``w2 = linear2.weight`` (D, F) (the JAX
function takes their transposes).
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import torch

from .prepared import KERNEL_DTYPES, aligned, one_kernel_dtype, prepare

__all__ = ["fused_ffn", "fused_ffn_ref", "kernel_dtype", "KERNEL_DTYPES", "launches",
           "launches_f32"]

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
_SRC = os.path.join(_CSRC, "fused_ffn.cu")
# the F-tile loop (shared with fused_encoder.cu) and the Hopper pieces it is built from
_HDRS = [os.path.join(_CSRC, "ffn_tile.cuh"), os.path.join(_CSRC, "attention_sm90.cuh")]
_SRC_F32 = os.path.join(_CSRC, "fused_ffn_f32x3.cu")
# its F-tile loop and the Hopper pieces (TF32 split, planes, wgmma) it is built from
_HDRS_F32 = [os.path.join(_CSRC, "ffn_tile_f32x3.cuh"), os.path.join(_CSRC, "attention_sm90.cuh")]
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# kernel launches made through fused_ffn, bf16 and fp32 (see chip_smoke.py)
launches = 0
launches_f32 = 0


def fused_ffn_ref(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                  b2: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch FFN over x's last axis: (..., D) -> (..., D2).  Products
    run in fp32 on operands already rounded to x's dtype, so on the card it
    is the kernel's arithmetic in another summation order."""
    dt, f32 = x.dtype, torch.float32
    h = torch.matmul(x.to(f32), w1.to(dt).to(f32).t()) + b1.to(f32)
    h = torch.relu(h).to(dt)
    return (torch.matmul(h.to(f32), w2.to(dt).to(f32).t()) + b2.to(f32)).to(dt)


# Tile constants of the kernels' sources (tests/test_torch_ffn.py and
# tests/test_torch_f32x3.py tie them to the .cu and .cuh files): F is taken
# in F-tiles of FT; a bf16 row tile holds 64 rows for each of CONSUMERS
# consumer warpgroups, an fp32 one ROWS (64 for each of CONSUMERS); the fp32
# encoder layer runs the same F-tile loop (ffn_tile_f32x3.cuh)
KERNEL_TILES = {"ffn_tile.cuh": {"D": 128, "FT": 64, "ROWS": 128, "STAGES": 3},
                "fused_ffn.cu": {"CONSUMERS": 3},
                "ffn_tile_f32x3.cuh": {"D": 128, "FT": 32, "ROWS": 128, "STAGES": 3},
                "fused_ffn_f32x3.cu": {"CONSUMERS": 2}}
F_MULTIPLE = KERNEL_TILES["ffn_tile.cuh"]["FT"]
TILE_ROWS = 64 * KERNEL_TILES["fused_ffn.cu"]["CONSUMERS"]
TILE_ROWS_F32 = KERNEL_TILES["ffn_tile_f32x3.cuh"]["ROWS"]


def weight_bytes_per_call(n: int, f: int = 2048, tile_rows: Optional[int] = None,
                          dtype: torch.dtype = torch.bfloat16) -> int:
    """Bytes of W1 and W2 the kernel of ``dtype`` fetches from L2 in one call
    over n rows, counted from its tiling (not read from the card): every
    block reads them once a row tile of ``tile_rows`` (default: the
    kernel's, ``TILE_ROWS`` or ``TILE_ROWS_F32``), bf16 (2 bytes a weight)
    or fp32 as a hi and a lo TF32 plane (8 bytes a weight)."""
    f32 = dtype == torch.float32
    rows = tile_rows or (TILE_ROWS_F32 if f32 else TILE_ROWS)
    return -(-n // rows) * 2 * (8 if f32 else 2) * KERNEL_TILES["ffn_tile.cuh"]["D"] * f


def tf32_split(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 ``w`` as (hi, lo), both TF32 values (the low 13 bits of each zero)
    rounded to nearest with ties away from zero, as ``cvt.rna.tf32.f32``
    rounds: hi = tf32(w), lo = tf32(w - hi), so |w - hi - lo| <= 2^-22 |w|."""

    def rna(x):
        return ((x.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)

    hi = rna(w)
    return hi, rna(w - hi)


def kperm(k: int) -> int:
    """The accumulator column that column k of a k8 step's TF32 A fragment
    holds (csrc/attention_sm90.cuh): 2 (k % 4) + k // 4."""
    return 2 * (k % 4) + k // 4


def planes(t: torch.Tensor) -> torch.Tensor:
    """The (R, K) matrices ``t`` (..., R, K) in wgmma's un-swizzled K-major
    core-matrix layout, flat: element (r, c) at (c // 4) R 4 + 4 r + c % 4
    (csrc/attention_sm90.cuh's planes)."""
    *lead, r, k = t.shape
    return t.reshape(*lead, r, k // 4, 4).transpose(-3, -2).reshape(*lead, r * k)


def ffn_stream_f32x3(w1: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """The fp32 kernels' FFN weight stream (csrc/ffn_tile_f32x3.cuh), flat: per
    F-tile of FT hidden units a W1 item (the tile's rows, K = D) then a W2
    item (W2's D rows over the tile's FT units, each 8 of them permuted by
    ``kperm``: column 8 j + k holds unit 8 j + kperm(k)), each as its hi and
    its lo TF32 plane (``tf32_split``, ``planes``).  w1 (F, D), w2 (D, F) in
    nn.Linear's layout."""
    ft = KERNEL_TILES["ffn_tile_f32x3.cuh"]["FT"]
    f, d = w1.shape
    perm = torch.tensor([8 * (i // 8) + kperm(i % 8) for i in range(f)], device=w2.device)
    t1 = planes(w1.reshape(f // ft, ft, d))
    t2 = planes(w2[:, perm].reshape(d, f // ft, ft).transpose(0, 1))
    return torch.stack((*tf32_split(t1), *tf32_split(t2)), 1).reshape(-1)


_LIB = None  # the bf16 library, bound once per process
_KERNEL = None  # its launch entry point
_LIB_F32 = None  # the fp32 library
_KERNEL_F32 = None  # its launch entry point


def kernel(dtype: torch.dtype = torch.bfloat16):
    """The launch entry point of ``dtype``'s kernel: built (if stale, nvcc
    for sm_90a) and bound on the first call, then cached, so a launch never
    reaches ``native``.  Both take (x, weights, b1, b2, out, n, f, stream):
    the bf16 one the weight set's TMA maps, the fp32 one its packed stream."""
    global _LIB, _KERNEL, _LIB_F32, _KERNEL_F32
    f32 = dtype == torch.float32
    if (_KERNEL_F32 if f32 else _KERNEL) is None:
        from ..native import build_library, nvcc_path

        name = "s3d_fused_ffn_f32" if f32 else "s3d_fused_ffn"
        lib = build_library(name, [_SRC_F32 if f32 else _SRC], [nvcc_path(), *NVCC_FLAGS],
                            headers=_HDRS_F32 if f32 else _HDRS)
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        if f32:
            _LIB_F32, _KERNEL_F32 = lib, fn
        else:
            _LIB, _KERNEL = lib, fn
    return _KERNEL_F32 if f32 else _KERNEL


def library(dtype: torch.dtype = torch.bfloat16) -> ctypes.CDLL:
    """The library of ``dtype``'s kernel (built by ``kernel``): besides the
    launch it exports the kernel's resident blocks an SM
    (``s3d_fused_ffn_blocks_per_sm``, ``s3d_fused_ffn_f32_blocks_per_sm``)
    and, bf16, the weight maps' encoder."""
    kernel(dtype)
    return _LIB_F32 if dtype == torch.float32 else _LIB


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


def prepared_weights(w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                     dtype: torch.dtype = torch.bfloat16):
    """The kernel of ``dtype``'s weight set, made once per weight set
    (``ops/prepared.py``): bf16 w1, w2, or fp32 (the split F-tile stream
    ``ffn_stream_f32x3``, one tensor, under a key of its own), and b1, b2
    in fp32."""
    if dtype == torch.float32:
        return prepare("fused_ffn_f32x3", [w1, w2], [b1, b2], dtype=dtype,
                       pack=lambda a, b: (ffn_stream_f32x3(a, b),))
    return prepare("fused_ffn", [w1, w2], [b1, b2])


def kernel_dtype(*named: Tuple[str, torch.Tensor]) -> torch.dtype:
    """The one dtype of the named tensors, which must be a kernel's
    (``KERNEL_DTYPES``): a ``TypeError`` names the first that is not, or
    that differs from the first tensor's.  Reads dtypes only, on any device."""
    return one_kernel_dtype("fused_ffn", named)


def fused_ffn(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
              b2: torch.Tensor) -> torch.Tensor:
    """relu(x W1^T + b1) W2^T + b2 over x's last axis: (..., D) -> (..., D).

    A CPU tensor takes the plain version.  A CUDA tensor launches the kernel
    of x's dtype, which needs bf16 or fp32 x, D = 128, F a positive multiple
    of 64 (the kernels' F-tile, ``F_MULTIPLE``) and every weight on x's
    device; anything else raises.  The kernels have no backward (like the TPU
    kernel they replace): with grad mode on and x or a weight that requires
    grad it raises rather than return a tensor cut from the graph.
    """
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_ffn: unsupported device {x.device}")
    if x.device.type == "cpu":
        return fused_ffn_ref(x, w1, b1, w2, b2)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, w1, b1, w2, b2)):
        raise RuntimeError("fused_ffn kernel is inference only (it has no backward, like "
                           "the TPU kernel it replaces): run it under torch.no_grad(), or "
                           "build the layer with route='plain' to train through the plain "
                           "version")
    dtype = kernel_dtype(("x", x))
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
    return _launch_kernel(x, w1, b1, w2, b2, dtype)


def _launch_kernel(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                   b2: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Launch ``dtype``'s kernel on a checked x (..., D) and weights."""
    global launches, launches_f32
    d, f = x.shape[-1], w1.shape[0]
    f32 = dtype == torch.float32
    xf = aligned(x.reshape(-1, d))
    n = xf.shape[0]
    out = torch.empty((n, d), dtype=x.dtype, device=x.device)
    if n == 0:
        return out.reshape(x.shape)
    launch = kernel(dtype)
    prep = prepared_weights(w1, b1, w2, b2, dtype)
    # the bf16 kernel reads the weights through their TMA maps, the fp32 one
    # streams the packed weights
    weights = prep.weights[0].data_ptr() if f32 else ctypes.addressof(_maps(prep))
    b1f, b2f = prep.vectors
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = launch(xf.data_ptr(), weights, b1f.data_ptr(), b2f.data_ptr(), out.data_ptr(),
                    n, f, stream)
    if rc != 0:
        raise RuntimeError(f"fused_ffn {dtype} kernel launch failed: CUDA error {rc}")
    if f32:
        launches_f32 += 1
    else:
        launches += 1
    return out.reshape(x.shape)
