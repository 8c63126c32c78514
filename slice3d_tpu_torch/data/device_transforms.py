"""Image preprocessing on the card (the JAX package's
``slice3d_tpu/data/device_transforms.py``).

The host decodes PNGs to raw RGBA uint8 (``Slice3DDataset(...,
device_preprocess=True)``); compositing, the resize and the [-1, 1]
normalisation run on the card, so the host ships a quarter of the float32
bytes and spends no time on the pixels.

Numerics: compositing and normalisation are the host path's
(``data/dataset.py::preprocess_image``) op for op, true divisions included,
so a source already at the target size gives the host path's values bit
for bit, on the card too.  A resize is
``F.interpolate(mode="bilinear", antialias=True)``, a triangle filter whose
support widens by the downscale factor, like the JAX package's
``jax.image.resize(method="linear", antialias=True)``; the two are different
implementations of that filter, and the host path (Pillow's fixed-point
BILINEAR) a third (tests/test_torch_device_transforms.py states both gaps).
"""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn.functional as F

from .. import resolve_device

__all__ = ["preprocess_rgba_device", "DeviceTransformLoader"]


def preprocess_rgba_device(raw: torch.Tensor, img_size: int,
                           white_bg: bool = False) -> torch.Tensor:
    """(..., H, W, 4) uint8 RGBA -> (..., img_size, img_size, 3) float32 in
    [-1, 1], on ``raw``'s device: composite (alpha mask onto black, or white
    where fully transparent), floor (the host path's uint8 cast), resize,
    normalise."""
    rgb = raw[..., :3].to(torch.float32)
    alpha = raw[..., 3:4].to(torch.float32)
    # a divisor on the tensor's device: CUDA divides by a Python scalar as a
    # multiplication by its reciprocal, one ulp off the host path's division
    d255 = torch.tensor(255.0, device=raw.device)
    if white_bg:
        # reference png_2_whitebg: fully transparent pixels -> white
        mask = (alpha == 0).to(torch.float32)
        out = 255.0 * mask + rgb * (1.0 - mask)
    else:
        out = rgb * (alpha / d255)
    out = torch.floor(out)
    h, w = out.shape[-3], out.shape[-2]
    if (h, w) != (img_size, img_size):
        lead = out.shape[:-3]
        x = out.reshape(-1, h, w, 3).permute(0, 3, 1, 2)
        x = F.interpolate(x, size=(img_size, img_size), mode="bilinear", align_corners=False,
                          antialias=True)
        out = x.permute(0, 2, 3, 1).reshape(lead + (img_size, img_size, 3))
    return (out / d255 - 0.5) / 0.5


class DeviceTransformLoader:
    """Wraps a loader whose batches carry raw uint8 RGBA arrays: each
    ``<name>_raw`` goes to the card as uint8 and comes out preprocessed as
    ``<name>`` (a float32 tensor there); other keys pass through.  Runs on
    CUDA unless ``device`` says otherwise."""

    def __init__(self, loader, img_size: int, white_bg: bool = False,
                 device: Optional[Union[str, torch.device]] = None):
        self.loader = loader
        self.img_size = img_size
        self.white_bg = white_bg
        self.device = resolve_device(device)

    def __len__(self) -> int:
        return len(self.loader)

    def __iter__(self):
        for batch in self.loader:
            out = {}
            for k, v in batch.items():
                if k.endswith("_raw"):
                    raw = torch.as_tensor(v).to(self.device, non_blocking=True)
                    out[k[:-4]] = preprocess_rgba_device(raw, self.img_size, self.white_bg)
                else:
                    out[k] = v
            yield out
