"""LPIPS perceptual distance, VGG variant (the JAX package's
``slice3d_tpu/models/lpips.py``; taming/richzhang ``lpips.LPIPS``, which the
reference VAE finetune's loss uses).

1. Scaling layer: [-1, 1] images shifted and scaled by the published
   constants.
2. The plain VGG16 trunk, cut into taming's five slices at relu1_2,
   relu2_2, relu3_3, relu4_3 and relu5_3 (post-ReLU taps of 64, 128, 256,
   512 and 512 channels).
3. Per tap: both images' features unit-normalised over the channels,
   squared difference, a learned 1x1 ``lin`` head to one channel, spatial
   mean; the five scores summed -> one distance a sample.

Module names are taming's (``net.slice{k}.{i}``, ``lin{k}.model.1``), so a
taming LPIPS ``state_dict`` loads strictly through :func:`load_lpips`; its
scaling constants are fixed, not loaded.  The trunk computes in the input's
dtype; normalisation, the heads and the mean run in fp32.
"""

from __future__ import annotations

from typing import List, Mapping

import torch
from torch import nn

from .layers import Conv2d

__all__ = ["LPIPS", "load_lpips"]

_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)
_VGG16_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512]
_SLICE_ENDS = (4, 9, 16, 23, 30)  # torchvision feature index after each tap's ReLU
_TAP_CHANNELS = (64, 128, 256, 512, 512)


class _NetLin(nn.Module):
    """taming's ``NetLinLayer``: dropout (identity at evaluation), 1x1 conv."""

    def __init__(self, cin: int):
        super().__init__()
        self.model = nn.Sequential(nn.Identity(), Conv2d(cin, 1, 1, bias=False))


class _VGG16Slices(nn.Module):
    """torchvision vgg16 ``features[:30]`` in five ``slice{k}`` Sequentials
    that keep the absolute child indices."""

    def __init__(self):
        super().__init__()
        layers: List[nn.Module] = []
        cin = 3
        for v in _VGG16_CFG:
            if v == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [Conv2d(cin, v, 3, padding=1), nn.ReLU()]
                cin = v
        start = 0
        for k, end in enumerate(_SLICE_ENDS):
            sl = nn.Sequential()
            for i in range(start, end):
                sl.add_module(str(i), layers[i])
            setattr(self, f"slice{k + 1}", sl)
            start = end

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        taps = []
        for k in range(len(_SLICE_ENDS)):
            x = getattr(self, f"slice{k + 1}")(x)
            taps.append(x)
        return taps


def _unit_normalize(feat: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    return feat / (torch.sqrt(torch.sum(feat * feat, dim=1, keepdim=True)) + eps)


class LPIPS(nn.Module):
    """x, y (B, H, W, 3) in [-1, 1] -> per-sample distance (B,) fp32."""

    def __init__(self):
        super().__init__()
        self.register_buffer("shift", torch.tensor(_SHIFT)[:, None, None], persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE)[:, None, None], persistent=False)
        self.net = _VGG16Slices()
        for k, c in enumerate(_TAP_CHANNELS):
            setattr(self, f"lin{k}", _NetLin(c))

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        def taps(img):
            img = img.permute(0, 3, 1, 2)
            return self.net(((img - self.shift.to(img.dtype)) / self.scale.to(img.dtype))
                            .contiguous())

        val = torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
        for k, (fx, fy) in enumerate(zip(taps(x), taps(y))):
            d = (_unit_normalize(fx.float()) - _unit_normalize(fy.float())) ** 2
            val = val + getattr(self, f"lin{k}").model(d).mean(dim=(2, 3))[:, 0]
        return val


def load_lpips(sd: Mapping[str, torch.Tensor]) -> LPIPS:
    """A frozen ``LPIPS`` from a taming LPIPS ``state_dict`` (strict on the
    trunk and the heads; the scaling layer's constant buffers, ``shift`` /
    ``scale`` or ``scaling_layer.*``, are checked against the constants and
    not loaded)."""
    model = LPIPS()
    own = {}
    for k, v in sd.items():
        name = k.rsplit(".", 1)[-1]
        if k in ("shift", "scale") or k.startswith("scaling_layer."):
            want = torch.tensor(_SHIFT if name == "shift" else _SCALE)
            if not torch.allclose(torch.as_tensor(v).reshape(-1).float(), want):
                raise ValueError(f"{k} is not LPIPS's {name} constant")
        else:
            own[k] = v
    model.load_state_dict(own)
    return model.requires_grad_(False).eval()
