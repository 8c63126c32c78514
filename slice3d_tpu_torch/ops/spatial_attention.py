"""Softmax attention of the LDM UNet's spatial blocks: CUDA kernels and plain twins.

Replaces ``slice3d_tpu/ops/pallas_attention.py::spatial_attention``: its
forward (``_attention_forward``, body ``_attn_kernel``) and its VJP
(``_attention_backward``, body ``_attn_bwd_kernel``, wired up by the custom
VJP of ``_make_attention``), which the JAX package runs in bf16 and in fp32.
The kernels are written by hand for Hopper (sm_90a), a pair for each
precision: bf16 in ``csrc/spatial_attention.cu`` and
``csrc/spatial_attention_bwd.cu`` (``wgmma``/TMA), fp32 in
``csrc/spatial_attention_f32x3.cu`` and ``csrc/spatial_attention_bwd_f32x3.cu``
(``wgmma`` in 3xTF32: each fp32 product as three TF32 products of operands
split into a hi and a lo TF32 part, which keeps fp32's accuracy); their
source notes say what bounds them and how the design answers that.

``spatial_attention`` is differentiable: with grad mode on and an input that
requires grad it runs through ``SpatialAttention`` (an autograd Function)
whose forward is the forward kernel (which then also saves the rows'
log-sum-exp) and whose backward is the backward kernel.  Without grad it
calls the forward kernel alone, as the sampler does.  A CPU tensor takes the
plain versions (``spatial_attention_ref``, ``spatial_attention_bwd_ref``); a
CUDA tensor takes the kernels of its dtype, which take bf16 or fp32 (every
tensor of a call one dtype) (B, H, T, DH) with T a multiple of
``KERNEL_T_MULTIPLE`` (a multiple of each of their tiles along T,
``KERNEL_TILES``) and DH 24 or 48 (the UNet's heads), and raise on anything
else.  Each kernel counts its launches: ``launches`` / ``launches_bwd`` (bf16),
``launches_f32`` / ``launches_bwd_f32`` (fp32).

The plain versions follow the TPU kernels' rounding points.  Forward: fp32
logits times ``scale``, fp32 softmax, probabilities cast to v's dtype, fp32
P.V, output in q's dtype.  Backward, per query block of 128 rows: the fp32
logits and softmax recomputed, ``dp = do v^T`` in fp32,
``ds = p (dp - rowsum(dp p)) scale`` cast to q's dtype, ``dq = ds k`` cast
to q's dtype, ``dk = ds^T q`` and ``dv = p(do's dtype)^T do`` accumulated
in fp32 over the blocks and cast to k's and v's dtype.  (fp64 inputs compute
in fp64, for ``gradcheck``.)  In fp32 every cast is the identity, and the
fp32 kernels differ from the plain versions by summation order, the
exponential and the rounding of their split products at the fp32 level.  The bf16 forward kernel runs an online softmax and
rounds the unnormalised ``exp(s - m)`` to bf16.  The bf16 backward kernel
makes one pass over blocks of keys: it recomputes the probabilities with one
exponential per logit from the saved log-sum-exp, takes ``rowsum(do o)``
from the bf16 output for ``rowsum(dp p)``, and sums dq in fp32 across the
key blocks in the order their additions reach the card's L2 cache, which
changes from run to run (dk and dv do not).  On the card the bf16 kernels
and the plain versions differ by those roundings.  The fp32 backward sums
every gradient in a fixed order (no atomics).
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from .prepared import KERNEL_DTYPES, aligned, one_kernel_dtype

__all__ = ["spatial_attention", "spatial_attention_ref", "spatial_attention_bwd_ref",
           "SpatialAttention", "attention_kernel_eligible", "kernel_dtype",
           "KERNEL_DTYPES", "KERNEL_HEAD_DIMS", "KERNEL_T_MULTIPLE", "KERNEL_TILES",
           "launches", "launches_bwd", "launches_f32", "launches_bwd_f32"]

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
_SRC = os.path.join(_CSRC, "spatial_attention.cu")
_SRC_BWD = os.path.join(_CSRC, "spatial_attention_bwd.cu")
_HDR = os.path.join(_CSRC, "attention_sm90.cuh")  # included by the wgmma sources
_SRC_F32 = os.path.join(_CSRC, "spatial_attention_f32x3.cu")
_SRC_BWD_F32 = os.path.join(_CSRC, "spatial_attention_bwd_f32x3.cu")
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
               "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# kernel launches made through spatial_attention: forward and backward, bf16
# and fp32 (see chip_smoke.py)
launches = 0
launches_bwd = 0
launches_f32 = 0
launches_bwd_f32 = 0

KERNEL_HEAD_DIMS = (24, 48)  # the UNet's heads at ds 1 and ds 2
# the kernels' tiles along T, by source and constant (csrc/<source>'s
# constexpr ints): T must be a multiple of each
KERNEL_TILES = {"spatial_attention.cu": {"BQ": 128, "BK": 128},
                "spatial_attention_bwd.cu": {"BKEYS": 128, "BQT": 64},
                "spatial_attention_f32x3.cu": {"BQ": 128, "TILE24": 128, "TILE48": 64},
                "spatial_attention_bwd_f32x3.cu": {"BROWS": 128, "TILE24": 64, "TILE48": 32}}
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


def _bind(name: str, src: str, headers, n_ptrs: int):
    """Build ``name`` from ``src`` (if stale, nvcc for sm_90a) and bind its
    C entry point of the same name: ``n_ptrs`` pointers, then bh, t, dh,
    scale and the stream."""
    from ..native import build_library, nvcc_path

    fn = getattr(build_library(name, [src], [nvcc_path(), *_NVCC_FLAGS], headers=headers),
                 name)
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 3
                   + [ctypes.c_float, ctypes.c_void_p])
    return fn


_KERNEL = None  # the bf16 forward library's entry point, bound once per process
_KERNEL_BWD = None  # the bf16 backward's
_KERNEL_F32 = None  # the fp32 forward's
_KERNEL_BWD_F32 = None  # the fp32 backward's


def kernel(dtype: torch.dtype = torch.bfloat16):
    """The forward kernel's C entry point for ``dtype``: built and bound on
    the first call, then cached, so a launch never reaches ``native``."""
    global _KERNEL, _KERNEL_F32
    if dtype == torch.float32:
        if _KERNEL_F32 is None:
            _KERNEL_F32 = _bind("s3d_spatial_attention_f32", _SRC_F32, (_HDR,), 5)
        return _KERNEL_F32
    if _KERNEL is None:
        _KERNEL = _bind("s3d_spatial_attention", _SRC, (_HDR,), 5)
    return _KERNEL


def kernel_bwd(dtype: torch.dtype = torch.bfloat16):
    """The backward kernels' C entry point for ``dtype``, built and bound
    once per process as :func:`kernel`."""
    global _KERNEL_BWD, _KERNEL_BWD_F32
    if dtype == torch.float32:
        if _KERNEL_BWD_F32 is None:
            _KERNEL_BWD_F32 = _bind("s3d_spatial_attention_bwd_f32", _SRC_BWD_F32, (_HDR,), 10)
        return _KERNEL_BWD_F32
    if _KERNEL_BWD is None:
        _KERNEL_BWD = _bind("s3d_spatial_attention_bwd", _SRC_BWD, (_HDR,), 11)
    return _KERNEL_BWD


def kernel_dtype(*named: Tuple[str, torch.Tensor]) -> torch.dtype:
    """The one dtype of the named tensors, which must be a kernel's
    (``KERNEL_DTYPES``): a ``TypeError`` names the first that is not, or
    that differs from the first tensor's.  Reads dtypes only, on any device."""
    return one_kernel_dtype("spatial_attention", named)


def _check_kernel_inputs(*named: Tuple[str, torch.Tensor]) -> None:
    """Raise unless every tensor is a (B, H, T, DH) on q's card, all bf16 or
    all fp32, with T a multiple of ``KERNEL_T_MULTIPLE`` and DH 24 or 48."""
    q = named[0][1]
    if q.device.type != "cuda":
        raise ValueError(f"spatial_attention: unsupported device {q.device}")
    if q.dim() != 4:
        raise ValueError(f"spatial_attention: q must be (B, H, T, DH), got {tuple(q.shape)}")
    for name, x in named:
        if x.shape != q.shape:
            raise ValueError(f"spatial_attention: {name} {tuple(x.shape)} is not q's "
                             f"(B, H, T, DH) {tuple(q.shape)}")
        if x.device != q.device:
            raise ValueError(f"spatial_attention: {name} on {x.device}, q on {q.device}")
    kernel_dtype(*named)
    t, dh = q.shape[-2:]
    if t % KERNEL_T_MULTIPLE or dh not in KERNEL_HEAD_DIMS:
        raise ValueError(f"spatial_attention kernel: unsupported shape T={t} DH={dh} "
                         f"(T a multiple of {KERNEL_T_MULTIPLE}, DH in "
                         f"{KERNEL_HEAD_DIMS})")


def _forward_kernel(q, k, v, scale: float, with_lse: bool
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch q's dtype's forward kernel on checked contiguous inputs;
    ``with_lse`` also returns the rows' fp32 log-sum-exp (log2 units) for the
    backward."""
    global launches, launches_f32
    b, h, t, dh = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device) if with_lse else None
    if out.numel() == 0:
        return out, lse
    f32 = q.dtype == torch.float32
    launch = kernel(q.dtype)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    lse.data_ptr() if with_lse else None, b * h, t, dh, float(scale), stream)
    if rc != 0:
        raise RuntimeError(f"spatial_attention {q.dtype} kernel launch failed: CUDA error {rc}")
    if f32:
        launches_f32 += 1
    else:
        launches += 1
    return out, lse


def _backward_kernel(q, k, v, out, lse, do, scale: float):
    """Launch q's dtype's backward kernels on checked contiguous inputs ->
    dq, dk, dv."""
    global launches_bwd, launches_bwd_f32
    b, h, t, dh = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0:
        return dq, dk, dv
    f32 = q.dtype == torch.float32
    delta = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    # the bf16 kernels sum dq in an fp32 scratch, zeroed; the fp32 ones in registers
    scratch = [] if f32 else [torch.zeros((b, h, t, dh), dtype=torch.float32,
                                          device=q.device)]
    launch = kernel_bwd(q.dtype)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), do.data_ptr(),
                    lse.data_ptr(), delta.data_ptr(), *(x.data_ptr() for x in scratch),
                    dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b * h, t, dh, float(scale),
                    stream)
    if rc != 0:
        raise RuntimeError(f"spatial_attention {q.dtype} backward kernel launch failed: "
                           f"CUDA error {rc}")
    if f32:
        launches_bwd_f32 += 1
    else:
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
        q, k, v = aligned(q), aligned(k), aligned(v)
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
            dq, dk, dv = _backward_kernel(q, k, v, out, lse, aligned(do), ctx.scale)
        return dq, dk, dv, None


def spatial_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      scale: float) -> torch.Tensor:
    """softmax(q k^T * scale) v over (B, H, T, DH) -> (B, H, T, DH),
    differentiable in q, k and v.

    A CPU tensor takes the plain versions; a CUDA tensor launches the kernels
    of its dtype (bf16 or fp32) or raises.  A bf16 kernel traps if one of its
    internal waits has not completed after 10 s (a fault, not a slow card:
    csrc/attention_sm90.cuh).  A trap is a sticky CUDA error: every later CUDA
    call of the process fails, and only a new process recovers.
    """
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return SpatialAttention.apply(q, k, v, scale)
    if q.device.type == "cpu":
        return spatial_attention_ref(q, k, v, scale)
    _check_kernel_inputs(("q", q), ("k", k), ("v", v))
    return _forward_kernel(aligned(q), aligned(k), aligned(v), scale, with_lse=False)[0]
