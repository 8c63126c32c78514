"""Nearest-neighbour resizing, NHWC, with the JAX package's index rule.

Source index ``min(int(i * in / out), in - 1)`` with ``i * (in / out)``
computed in fp32, as ``slice3d_tpu/ops/resize.py`` does.  It equals
``F.interpolate(mode="nearest")`` at the sizes the conditioning encoder uses
(tests/test_torch_ldm.py holds them to it).
"""

from __future__ import annotations

import torch

__all__ = ["resize_nearest"]


def _nearest_indices(out_size: int, in_size: int, device) -> torch.Tensor:
    idx = torch.arange(out_size, dtype=torch.float32, device=device) * (in_size / out_size)
    return torch.clamp(idx.to(torch.int64), max=in_size - 1)


def resize_nearest(x: torch.Tensor, out_hw) -> torch.Tensor:
    """Nearest-neighbour resize of (..., H, W, C) to (..., h, w, C)."""
    h_in, w_in = x.shape[-3], x.shape[-2]
    rows = _nearest_indices(out_hw[0], h_in, x.device)
    cols = _nearest_indices(out_hw[1], w_in, x.device)
    return x.index_select(-3, rows).index_select(-2, cols)
