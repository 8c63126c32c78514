"""Bilinear plane sampling of NHWC feature maps at normalized points.

The function of ``F.grid_sample(..., mode="bilinear", padding_mode="zeros",
align_corners=True)``, written as four row gathers (the JAX package's
``slice3d_tpu/ops/grid_sample.py``): the corner weights are fp32 (fp64 for
fp64 points) and cast to the features' dtype, as there.  Plain ops throughout, so it can be
differentiated twice with respect to the points (``F.grid_sample``'s
backward has no derivative of its own), which the mesh polish needs.
"""

from __future__ import annotations

import torch

__all__ = ["grid_sample_2d"]


def grid_sample_2d(features: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """features (N, H, W, C), coords (N, M, 2) in [-1, 1] (``[..., 0]``
    indexes the width) -> (N, M, C) in the features' dtype."""
    n, h, w, c = features.shape
    m = coords.shape[1]
    ct = torch.promote_types(coords.dtype, torch.float32)  # fp32, or fp64 if given
    x = coords[..., 0].to(ct)
    y = coords[..., 1].to(ct)
    px = (x + 1.0) * 0.5 * (w - 1)
    py = (y + 1.0) * 0.5 * (h - 1)
    x0 = torch.floor(px)
    y0 = torch.floor(py)
    wx = px - x0
    wy = py - y0
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    flat = features.reshape(n * h * w, c)
    base = (torch.arange(n, device=features.device) * (h * w))[:, None]

    def corner(xi, yi, weight):
        valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        weight = torch.where(valid, weight, torch.zeros_like(weight))
        idx = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1) + base
        rows = flat.index_select(0, idx.reshape(-1)).reshape(n, m, c)
        return rows * weight.to(features.dtype)[..., None]

    return (corner(x0i, y0i, (1 - wx) * (1 - wy))
            + corner(x0i + 1, y0i, wx * (1 - wy))
            + corner(x0i, y0i + 1, (1 - wx) * wy)
            + corner(x0i + 1, y0i + 1, wx * wy))
