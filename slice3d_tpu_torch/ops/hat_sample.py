"""Bilinear plane sampling as a dense hat-basis matmul (gather-free).

Bilinear interpolation with zero padding is a linear map of the plane: the
weight of lattice row ``r = (yr, xr)`` for a point is
``relu(1 - |px - xr|) * relu(1 - |py - yr|)``; at most 4 are non-zero and an
out-of-range point gets none.  For small pyramid levels the (M, h*w) weight
matrix is cheap and one matmul replaces four row gathers; larger levels go
back to the caller's gather (routing threshold ``max_rows``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

__all__ = ["hat_weights", "hat_sample_level", "hat_sample_sum"]


def hat_weights(p: torch.Tensor, n: int, dtype: torch.dtype) -> torch.Tensor:
    """p (..., N) continuous pixel coords -> (..., N, n) hat weights,
    computed in fp32 and cast to ``dtype``."""
    grid = torch.arange(n, dtype=torch.float32, device=p.device)
    w = torch.clamp(1.0 - torch.abs(p.to(torch.float32)[..., None] - grid), min=0.0)
    return w.to(dtype)


def hat_sample_level(plane: torch.Tensor, px: torch.Tensor,
                     py: torch.Tensor) -> torch.Tensor:
    """plane (B, h, w, C); px/py (B, M) pixel coords (align_corners scaling
    applied) -> (B, M, C), zero for out-of-range points."""
    b, h, w, c = plane.shape
    wx = hat_weights(px, w, plane.dtype)  # (B, M, w)
    wy = hat_weights(py, h, plane.dtype)  # (B, M, h)
    wmat = (wy[:, :, :, None] * wx[:, :, None, :]).reshape(b, -1, h * w)
    return torch.bmm(wmat, plane.reshape(b, h * w, c))


def hat_sample_sum(planes: Sequence[torch.Tensor], uv: torch.Tensor,
                   obj_index: Optional[torch.Tensor] = None, max_rows: int = 2048
                   ) -> Tuple[Optional[torch.Tensor], List[torch.Tensor]]:
    """Sum of bilinear samples over the levels with ``h * w <= max_rows``.

    planes: [(B, h, w, C)]; uv (b, M, 2) in [-1, 1].  ``obj_index`` (b,)
    selects the plane set each uv row samples (default: row i samples set i,
    b == B).  Returns (total (b, M, C) or None, the planes left for the
    gather path).
    """
    x = uv[..., 0].to(torch.float32)
    y = uv[..., 1].to(torch.float32)
    total = None
    rest = []
    for plane in planes:
        _, h, w, _ = plane.shape
        if h * w > max_rows:
            rest.append(plane)
            continue
        if obj_index is not None:  # a small level: the copy is cheap
            plane = plane.index_select(0, obj_index)
        s = hat_sample_level(plane, (x + 1.0) * 0.5 * (w - 1), (y + 1.0) * 0.5 * (h - 1))
        total = s if total is None else total + s
    return total, rest
