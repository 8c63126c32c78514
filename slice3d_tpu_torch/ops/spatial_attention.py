"""Softmax attention of the LDM UNet's spatial blocks: CUDA kernels and plain twins.

Replaces ``slice3d_tpu/ops/pallas_attention.py::spatial_attention``: its
forward (``_attention_forward``, body ``_attn_kernel``) and its VJP
(``_attention_backward``, body ``_attn_bwd_kernel``, wired up by the custom
VJP of ``_make_attention``).  The kernels (``csrc/spatial_attention.cu`` and
``csrc/spatial_attention_bwd.cu``) are written by hand for Hopper (sm_90a);
their source notes say what bounds them and how the design answers that.

``spatial_attention`` is differentiable: with grad mode on and an input that
requires grad it runs through ``SpatialAttention`` (an autograd Function)
whose forward is the forward kernel (which then also saves the rows'
log-sum-exp) and whose backward is the backward kernel.  Without grad it
calls the forward kernel alone, as the sampler does.  A CPU tensor takes the
plain versions (``spatial_attention_ref``, ``spatial_attention_bwd_ref``); a
CUDA tensor takes the kernels, which take bf16 (B, H, T, DH) with T a
multiple of ``KERNEL_T_MULTIPLE`` (a multiple of each of their tiles along T,
``KERNEL_TILES``) and DH 24 or 48 (the UNet's heads), and raise on anything
else.

The plain versions follow the TPU kernels' rounding points.  Forward: fp32
logits times ``scale``, fp32 softmax, probabilities cast to v's dtype, fp32
P.V, output in q's dtype.  Backward, per query block of 128 rows: the fp32
logits and softmax recomputed, ``dp = do v^T`` in fp32,
``ds = p (dp - rowsum(dp p)) scale`` cast to q's dtype, ``dq = ds k`` cast
to q's dtype, ``dk = ds^T q`` and ``dv = p(do's dtype)^T do`` accumulated
in fp32 over the blocks and cast to k's and v's dtype.  (fp64 inputs compute
in fp64, for ``gradcheck``.)  The forward kernel runs an online softmax and
rounds the unnormalised ``exp(s - m)`` to bf16.  The backward kernel makes
one pass over blocks of keys: it recomputes the probabilities with one
exponential per logit from the saved log-sum-exp, takes ``rowsum(do o)``
from the bf16 output for ``rowsum(dp p)``, and sums dq in fp32 across the
key blocks in the order their additions reach the card's L2 cache, which
changes from run to run (dk and dv do not).  On the card the kernels and the
plain versions differ by those roundings.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

__all__ = ["spatial_attention", "spatial_attention_ref", "spatial_attention_bwd_ref",
           "SpatialAttention", "attention_kernel_eligible", "KERNEL_HEAD_DIMS",
           "KERNEL_T_MULTIPLE", "KERNEL_TILES", "launches", "launches_bwd"]

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
_SRC = os.path.join(_CSRC, "spatial_attention.cu")
_SRC_BWD = os.path.join(_CSRC, "spatial_attention_bwd.cu")
_HDR = os.path.join(_CSRC, "attention_sm90.cuh")  # included by both
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
               "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# kernel launches made through spatial_attention: forward and backward (see
# chip_smoke.py)
launches = 0
launches_bwd = 0

KERNEL_HEAD_DIMS = (24, 48)  # the UNet's heads at ds 1 and ds 2
# the kernels' tiles along T, by source and constant (csrc/<source>'s
# constexpr ints): T must be a multiple of each
KERNEL_TILES = {"spatial_attention.cu": {"BQ": 128, "BK": 128},
                "spatial_attention_bwd.cu": {"BKEYS": 128, "BQT": 64}}
KERNEL_T_MULTIPLE = 128
BWD_BLOCK_Q = 128  # the TPU backward's query block: max(block_q // 4, 128)


def attention_kernel_eligible(t: int) -> bool:
    """The UNet's routing rule (``ldm_unet.py`` AttentionBlock): long
    sequences take ``spatial_attention``, short ones the plain einsum path."""
    return t >= 1024 and t % 512 == 0


def _acc(dtype: torch.dtype) -> torch.dtype:
    """The plain versions' arithmetic: fp32, or fp64 for fp64 inputs."""
    return torch.promote_types(dtype, torch.float32)


def spatial_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: float) -> torch.Tensor:
    """Plain PyTorch attention over (B, H, T, DH), rounded where the TPU
    kernel rounds: probabilities to v's dtype, the output to q's dtype."""
    f = _acc(q.dtype)
    logits = torch.matmul(q.to(f), k.to(f).transpose(-1, -2)) * scale
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(probs.to(f), v.to(f)).to(q.dtype)


def spatial_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              do: torch.Tensor, scale: float
                              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain blockwise VJP of :func:`spatial_attention_ref`: (dq, dk, dv) from
    the output's gradient ``do``, with the TPU backward kernel's rounding
    points (module docstring), ``BWD_BLOCK_Q`` query rows at a time."""
    f = _acc(q.dtype)
    do = do.to(q.dtype)
    kf, vf = k.to(f), v.to(f)
    dk = torch.zeros(k.shape, dtype=f, device=k.device)
    dv = torch.zeros(v.shape, dtype=f, device=v.device)
    dq = []
    for start in range(0, q.shape[-2], BWD_BLOCK_Q):
        qb = q[..., start:start + BWD_BLOCK_Q, :].to(f)
        dob = do[..., start:start + BWD_BLOCK_Q, :]
        p = torch.softmax(torch.matmul(qb, kf.transpose(-1, -2)) * scale, dim=-1)
        dp = torch.matmul(dob.to(f), vf.transpose(-1, -2))
        ds = (p * (dp - (dp * p).sum(-1, keepdim=True)) * scale).to(q.dtype).to(f)
        dq.append(torch.matmul(ds, kf).to(q.dtype))
        dk += torch.matmul(ds.transpose(-1, -2), qb)
        dv += torch.matmul(p.to(do.dtype).to(f).transpose(-1, -2), dob.to(f))
    return torch.cat(dq, dim=-2), dk.to(k.dtype), dv.to(v.dtype)


def _build(name: str, src: str):
    from ..native import build_library, nvcc_path

    return build_library(name, [src], [nvcc_path(), *_NVCC_FLAGS], headers=[_HDR])


_KERNEL = None  # the forward library's entry point, bound once per process
_KERNEL_BWD = None  # the backward's


def kernel():
    """The forward kernel's C entry point: built (if stale, nvcc for sm_90a)
    and bound on the first call, then cached, so a launch never reaches
    ``native``."""
    global _KERNEL
    if _KERNEL is None:
        fn = _build("s3d_spatial_attention", _SRC).s3d_spatial_attention
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                       + [ctypes.c_float, ctypes.c_void_p])
        _KERNEL = fn
    return _KERNEL


def kernel_bwd():
    """The backward kernel's C entry point, built and bound once per process
    as :func:`kernel`."""
    global _KERNEL_BWD
    if _KERNEL_BWD is None:
        fn = _build("s3d_spatial_attention_bwd", _SRC_BWD).s3d_spatial_attention_bwd
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 3
                       + [ctypes.c_float, ctypes.c_void_p])
        _KERNEL_BWD = fn
    return _KERNEL_BWD


def _check_kernel_inputs(*named: Tuple[str, torch.Tensor]) -> None:
    """Raise unless every tensor is a bf16 (B, H, T, DH) on q's card with T a
    multiple of ``KERNEL_T_MULTIPLE`` and DH 24 or 48."""
    q = named[0][1]
    if q.device.type != "cuda":
        raise ValueError(f"spatial_attention: unsupported device {q.device}")
    if q.dim() != 4:
        raise ValueError(f"spatial_attention: q must be (B, H, T, DH), got {tuple(q.shape)}")
    for name, x in named:
        if x.shape != q.shape:
            raise ValueError(f"spatial_attention: {name} {tuple(x.shape)} is not q's "
                             f"(B, H, T, DH) {tuple(q.shape)}")
        if x.dtype != torch.bfloat16:
            raise TypeError(f"spatial_attention kernel takes bf16, got {name} {x.dtype}")
        if x.device != q.device:
            raise ValueError(f"spatial_attention: {name} on {x.device}, q on {q.device}")
    t, dh = q.shape[-2:]
    if t % KERNEL_T_MULTIPLE or dh not in KERNEL_HEAD_DIMS:
        raise ValueError(f"spatial_attention kernel: unsupported shape T={t} DH={dh} "
                         f"(T a multiple of {KERNEL_T_MULTIPLE}, DH in "
                         f"{KERNEL_HEAD_DIMS})")


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """``x`` contiguous at a 16-byte aligned address (the kernels' TMA loads
    need it; a view into a larger tensor may start anywhere)."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _forward_kernel(q, k, v, scale: float, with_lse: bool
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch the forward kernel on checked contiguous inputs; ``with_lse``
    also returns the rows' fp32 log-sum-exp (log2 units) for the backward."""
    global launches
    b, h, t, dh = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device) if with_lse else None
    if out.numel() == 0:
        return out, lse
    launch = kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    lse.data_ptr() if with_lse else None, b * h, t, dh, float(scale), stream)
    if rc != 0:
        raise RuntimeError(f"spatial_attention kernel launch failed: CUDA error {rc}")
    launches += 1
    return out, lse


def _backward_kernel(q, k, v, out, lse, do, scale: float):
    """Launch the backward kernels on checked contiguous inputs -> dq, dk, dv."""
    global launches_bwd
    b, h, t, dh = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0:
        return dq, dk, dv
    delta = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    dq_accum = torch.zeros((b, h, t, dh), dtype=torch.float32, device=q.device)
    launch = kernel_bwd()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), do.data_ptr(),
                    lse.data_ptr(), delta.data_ptr(), dq_accum.data_ptr(), dq.data_ptr(),
                    dk.data_ptr(), dv.data_ptr(), b * h, t, dh, float(scale), stream)
    if rc != 0:
        raise RuntimeError(f"spatial_attention backward kernel launch failed: CUDA error {rc}")
    launches_bwd += 1
    return dq, dk, dv


class SpatialAttention(torch.autograd.Function):
    """softmax(q k^T * scale) v with the kernels (CUDA) or the plain versions
    (CPU) both ways.  The CUDA path saves q, k, v, the output and the rows'
    log-sum-exp; the CPU path q, k, v."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float):
        ctx.scale = scale
        if q.device.type == "cpu":
            ctx.save_for_backward(q, k, v)
            return spatial_attention_ref(q, k, v, scale)
        _check_kernel_inputs(("q", q), ("k", k), ("v", v))
        q, k, v = _aligned(q), _aligned(k), _aligned(v)
        out, lse = _forward_kernel(q, k, v, scale, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        if do.device.type == "cpu":
            q, k, v = ctx.saved_tensors
            dq, dk, dv = spatial_attention_bwd_ref(q, k, v, do, ctx.scale)
        else:
            q, k, v, out, lse = ctx.saved_tensors
            _check_kernel_inputs(("q", q), ("do", do))
            dq, dk, dv = _backward_kernel(q, k, v, out, lse, _aligned(do), ctx.scale)
        return dq, dk, dv, None


def spatial_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      scale: float) -> torch.Tensor:
    """softmax(q k^T * scale) v over (B, H, T, DH) -> (B, H, T, DH),
    differentiable in q, k and v.

    A CPU tensor takes the plain versions; a CUDA tensor launches the kernels
    or raises.  A kernel traps if one of its internal waits has not completed
    after 10 s (a fault, not a slow card: csrc/attention_sm90.cuh).  A trap
    is a sticky CUDA error: every later CUDA call of the process fails, and
    only a new process recovers.
    """
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return SpatialAttention.apply(q, k, v, scale)
    if q.device.type == "cpu":
        return spatial_attention_ref(q, k, v, scale)
    _check_kernel_inputs(("q", q), ("k", k), ("v", v))
    return _forward_kernel(_aligned(q), _aligned(k), _aligned(v), scale, with_lse=False)[0]
