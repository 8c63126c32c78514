"""Softmax attention of the LDM UNet's spatial blocks: CUDA kernel and plain twin.

Replaces ``slice3d_tpu/ops/pallas_attention.py::spatial_attention`` (its
forward, ``_attention_forward`` with the body ``_attn_kernel``).  The kernel
(``csrc/spatial_attention.cu``) is written by hand for Hopper (sm_90a); its
source note says what bounds it and how the design answers that.  The
backward (``_attention_backward``) belongs to LDM training and is not here.

``spatial_attention`` takes a CPU tensor to ``spatial_attention_ref`` and a
CUDA tensor to the kernel, which takes bf16 (B, H, T, DH) with T a multiple
of 64 and DH 24 or 48 (the UNet's heads), and raises on anything else.

The plain version follows the TPU kernel: fp32 logits times ``scale``, fp32
softmax, probabilities cast to v's dtype, fp32 P.V, output in q's dtype.  The
kernel runs an online softmax instead: it rounds the unnormalised
``exp(s - m)`` to bf16 and divides by the fp32 row sum at the end, so on the
card the two differ by bf16 rounding of the probabilities.
"""

from __future__ import annotations

import ctypes
import os

import torch

__all__ = ["spatial_attention", "spatial_attention_ref", "attention_kernel_eligible",
           "KERNEL_HEAD_DIMS", "launches"]

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "csrc", "spatial_attention.cu")

# kernel launches made through spatial_attention (see chip_smoke.py)
launches = 0

KERNEL_HEAD_DIMS = (24, 48)  # the UNet's heads at ds 1 and ds 2
KERNEL_T_MULTIPLE = 64


def attention_kernel_eligible(t: int) -> bool:
    """The UNet's routing rule (``ldm_unet.py`` AttentionBlock): long
    sequences take ``spatial_attention``, short ones the plain einsum path."""
    return t >= 1024 and t % 512 == 0


def spatial_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: float) -> torch.Tensor:
    """Plain PyTorch attention over (B, H, T, DH), rounded where the TPU
    kernel rounds: probabilities to v's dtype, the output to q's dtype."""
    f32 = torch.float32
    logits = torch.matmul(q.to(f32), k.to(f32).transpose(-1, -2)) * scale
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(probs.to(f32), v.to(f32)).to(q.dtype)


_KERNEL = None  # the library's entry point, bound once per process


def kernel():
    """The kernel's C entry point: built (if stale, nvcc for sm_90a) and
    bound on the first call, then cached, so a launch never reaches
    ``native``."""
    global _KERNEL
    if _KERNEL is None:
        from ..native import build_library, nvcc_path

        lib = build_library(
            "s3d_spatial_attention", [_SRC],
            [nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"])
        fn = lib.s3d_spatial_attention
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                       + [ctypes.c_float, ctypes.c_void_p])
        _KERNEL = fn
    return _KERNEL


def spatial_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      scale: float) -> torch.Tensor:
    """softmax(q k^T * scale) v over (B, H, T, DH) -> (B, H, T, DH).

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    or raises.
    """
    global launches
    if q.device.type == "cpu":
        return spatial_attention_ref(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"spatial_attention: unsupported device {q.device}")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"spatial_attention: q, k, v must share one (B, H, T, DH) "
                         f"shape, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype != torch.bfloat16:
            raise TypeError(f"spatial_attention kernel takes bf16, got {name} {x.dtype}")
        if x.device != q.device:
            raise ValueError(f"spatial_attention: {name} on {x.device}, q on {q.device}")
    b, h, t, dh = q.shape
    if t % KERNEL_T_MULTIPLE or dh not in KERNEL_HEAD_DIMS:
        raise ValueError(f"spatial_attention kernel: unsupported shape T={t} DH={dh} "
                         f"(T a multiple of {KERNEL_T_MULTIPLE}, DH in "
                         f"{KERNEL_HEAD_DIMS})")
    qc, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(qc)
    if out.numel() == 0:
        return out
    launch = kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = launch(qc.data_ptr(), kc.data_ptr(), vc.data_ptr(),
                                       out.data_ptr(), b * h, t, dh, float(scale), stream)
    if rc != 0:
        raise RuntimeError(f"spatial_attention kernel launch failed: CUDA error {rc}")
    launches += 1
    return out
