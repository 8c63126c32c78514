"""slice3d_tpu_torch: the PyTorch/CUDA port of slice3d_tpu for NVIDIA Hopper.

The JAX package ``slice3d_tpu`` stays the reference; this package imports
neither it nor JAX.  Entry points run on the card unless the caller passes
``device="cpu"``.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__version__ = "0.1.0"

__all__ = ["__version__", "resolve_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another.  Raises if CUDA is asked for (or defaulted to) and missing."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "on the CPU")
    return dev
