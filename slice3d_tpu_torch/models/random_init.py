"""Seeded random weights for models that have no checkpoint in the repository.

Every parameter and normalisation statistic is drawn from the caller's
``torch.Generator``, the layers that the reference zero-initialises included
(the ADM UNet's ``out_layers.3``, ``proj_out`` and ``out.2``): with those
left at zero the attention blocks' output would be multiplied by zero and a
broken attention kernel would go unseen.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from .layers import _SelfAttention

__all__ = ["random_init_"]

_NORMS = (nn.GroupNorm, nn.LayerNorm, nn.BatchNorm2d)


@torch.no_grad()
def random_init_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """In place: conv and linear weights and biases U(+-1/sqrt(fan_in))
    (torch's default bound); norm scales 1 + U(+-0.1) and biases U(+-0.1);
    BatchNorm running means U(+-0.1) and variances U(0.5, 1.5); embeddings
    N(0, 1); the transformer's fused in-projection Xavier-uniform with a
    U(+-0.1) bias.  Returns the model in eval mode."""
    g = generator

    def uniform(t, lo, hi):
        t.uniform_(lo, hi, generator=g)

    for mod in model.modules():
        if isinstance(mod, (nn.Conv1d, nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            w = mod.weight
            bound = 1.0 / math.sqrt(w.shape[1] * w[0][0].numel())
            uniform(w, -bound, bound)
            if mod.bias is not None:
                uniform(mod.bias, -bound, bound)
        elif isinstance(mod, _NORMS):
            uniform(mod.weight, 0.9, 1.1)
            uniform(mod.bias, -0.1, 0.1)
            if isinstance(mod, nn.BatchNorm2d):
                uniform(mod.running_mean, -0.1, 0.1)
                uniform(mod.running_var, 0.5, 1.5)
        elif isinstance(mod, nn.Embedding):
            mod.weight.normal_(generator=g)
        elif isinstance(mod, _SelfAttention):
            w = mod.in_proj_weight
            bound = math.sqrt(6.0 / (w.shape[0] + w.shape[1]))
            uniform(w, -bound, bound)
            uniform(mod.in_proj_bias, -0.1, 0.1)
    return model.eval()
