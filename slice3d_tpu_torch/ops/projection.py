"""Perspective projection of query points onto the input image plane."""

from __future__ import annotations

import torch

__all__ = ["project_points"]


def project_points(points: torch.Tensor, trans_mat_tp: torch.Tensor) -> torch.Tensor:
    """points (B, M, 3) camera-aligned, trans_mat_tp (B, 4, 3) ->
    (B, M, 2) normalized image coords clamped to [-1, 1].

    Always fp32, whatever the model's compute dtype: the projected pixel
    coords feed bilinear sampling, where bf16 rounding would move the taps.
    """
    p = points.to(torch.float32)
    t = trans_mat_tp.to(torch.float32)
    uvw = torch.matmul(p, t[:, :3]) + t[:, 3:4]  # [q, 1] @ T
    xy = uvw[..., :2] / uvw[..., 2:3]
    return torch.clamp(2.0 * (xy - 0.5), -1.0, 1.0)
