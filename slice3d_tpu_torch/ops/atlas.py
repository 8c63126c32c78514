"""12-slice latent <-> 4x4 spatial atlas tiling (NHWC).

The LDM diffuses one (4h, 4w, c) latent atlas holding the 12 slice latents
in a 4x4 tile grid: row 0 = slices 0-3, row 1 = slices 4-7, row 2 = slices
8-11, row 3 = zero padding.  Decoding un-tiles row-major and keeps the first
``keep`` tiles.  Pure reshapes.
"""

from __future__ import annotations

import torch

__all__ = ["tile_slices_to_atlas", "untile_atlas", "N_SLICES", "N_TILES"]

N_SLICES = 12
N_TILES = 16


def tile_slices_to_atlas(z: torch.Tensor) -> torch.Tensor:
    """(B, 12, h, w, C) slice latents -> (B, 4h, 4w, C) atlas."""
    b, s, h, w, c = z.shape
    if s != N_SLICES:
        raise ValueError(f"expected 12 slice latents, got {s}")
    z = torch.cat([z, z.new_zeros((b, N_TILES - s, h, w, c))], dim=1)
    z = z.reshape(b, 4, 4, h, w, c).permute(0, 1, 3, 2, 4, 5)  # (B, row, h, col, w, C)
    return z.reshape(b, 4 * h, 4 * w, c)


def untile_atlas(atlas: torch.Tensor, keep: int = 13) -> torch.Tensor:
    """(B, 4h, 4w, C) atlas -> (B, keep, h, w, C) tiles, row-major order."""
    b, hh, ww, c = atlas.shape
    h, w = hh // 4, ww // 4
    z = atlas.reshape(b, 4, h, 4, w, c).permute(0, 1, 3, 2, 4, 5)  # (B, row, col, h, w, C)
    return z.reshape(b, N_TILES, h, w, c)[:, :keep]
